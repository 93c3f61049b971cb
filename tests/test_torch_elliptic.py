"""The elliptic friction cone (cone='elliptic') of the port against the JAX
package, float64 on the CPU: the solver's zone formulas at inputs in each
of the three zones and within 1e-12 of both zone boundaries (≤ 1e-12); the
constraint rows (the structured x block, the frictionless c block) and the
dense efc_force of tests/test_elliptic.py's MIXED_XML (condim 1/3/4,
impratio 1.5) and of its condim-6 variant, uncompacted and compacted
(≤ 1e-9); a 140-step rollout of MIXED_XML (MuJoCo alone through the
first 50, the free fall) against the JAX package and against MuJoCo's
mj_step (≤ 1e-8); the G1 flat snapshot with the option
written in against MuJoCo's compile with it; and a reset and six env-steps
of Flat-Tiny with cone='elliptic' against the JAX env (≤ 1e-6). One G1
flat step with the elliptic cone and per-env foot friction is held to the
JAX package in tests/test_torch_step.py."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import g1_flat_arrays
from mjlab_torch.asset_zoo.g1_flat_scene import flat_scene_spec, robot_spec
from mjlab_torch.physics import constraint as tcon
from mjlab_torch.physics import io as tio
from mjlab_torch.physics import pipeline as tpipe
from mjlab_torch.physics import solver as tsolver
from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import pipeline as jpipe
from mjlab_tpu.physics import smooth as jsmooth
from mjlab_tpu.physics import solver as jsolver
from test_elliptic import MIXED_XML
from test_torch_tiny import FLAT, _pair, six_env_steps
from torch_parity import data_leaves, jax_batch, quick_jit

ZONE_TOL = 1e-12
ROW_TOL = 1e-9
ROLLOUT_TOL = 1e-8
ROLLOUT_STEPS = 140
FREE_FALL_STEPS = 50  # no contact before step 51 (the first sphere lands)
CONDIM6_XML = MIXED_XML.replace('condim="4"', 'condim="6"').replace(
    'friction="0.7 0.08 .001"', 'friction="0.7 0.1 0.05"')


def _close(got, want, tol, what):
  got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the zone formulas
# ---------------------------------------------------------------------------

# per entry: the zone it is put in and, at a boundary, its offset from it
ZONES = (('top', 0.0), ('bottom', 0.0), ('middle', 0.0),
         ('top', 2e-13), ('top', -2e-13), ('top', 8e-13), ('top', -8e-13),
         ('bottom', 2e-13), ('bottom', -2e-13), ('bottom', 8e-13),
         ('bottom', -8e-13))


def _zone_inputs(dm: int, seed: int):
  """(jx, jdx, xD, mu, fr, act) of 12 contacts per entry of ZONES, each
  with a leading axis of its own (so the summed outputs stay per contact):
  the normal residual set into the entry's zone, or within 1e-12 of its
  boundary (top: N = mu Tu; bottom: mu N + Tu = 0). Values of order one,
  so that 1e-12 is far above the last bits."""
  rng = np.random.default_rng(seed)
  rows = []
  for zone, off in ZONES:
    nx = 12
    fr = rng.uniform(0.5, 1.0, size=(nx, dm - 1))
    mu = fr[:, 0] / np.sqrt(rng.uniform(1.0, 2.0, size=nx))
    jt = rng.normal(size=(nx, dm - 1)) * rng.choice([0.02, 0.1, 0.3],
                                                   size=(nx, 1))
    u = jt * fr / mu[:, None]
    tu = np.sqrt((u * u).sum(-1))
    if zone == 'top':
      n = mu * tu + (off if off else rng.uniform(0.05, 0.3, size=nx))
    elif zone == 'bottom':
      n = -tu / mu + (off if off else -rng.uniform(0.05, 0.3, size=nx))
    else:
      n = -tu / mu + rng.uniform(0.1, 0.9, size=nx) * (mu * tu + tu / mu)
    rows.append((np.concatenate([n[:, None], jt], -1),
                 0.3 * rng.normal(size=(nx, dm)),
                 rng.uniform(0.5, 2.0, (nx, dm)), mu, fr,
                 rng.random(nx) < 0.9))
  out = tuple(np.concatenate([r[i] for r in rows]) for i in range(6))
  return tuple(x[:, None] for x in out)


@pytest.mark.parametrize('dm', [3, 4, 6])
def test_zone_formulas_match_jax(dm):
  jx, jdx, xD, mu, fr, act = _zone_inputs(dm, seed=dm)
  j = lambda *a: tuple(jnp.asarray(x) for x in a)
  t = lambda *a: tuple(torch.as_tensor(x) for x in a)
  args = (jx, xD, mu, fr, act)

  tz = tsolver._elliptic_zones(*t(*args))
  jz = jsolver._elliptic_zones(*j(*args))
  for name, a, b in zip(('mid', 'bot', 'K', 'z', 'w', 'Tu'), tz, jz):
    _close(a, b, ZONE_TOL, name)
  mid, bot, on = tz[0].numpy()[:, 0], tz[1].numpy()[:, 0], act[:, 0]
  top = on & ~mid & ~bot
  assert mid.any() and bot.any() and top.any()
  # the entries put within 1e-12 of a boundary fall on both of its sides
  for zone, inside in (('top', top), ('bottom', bot)):
    near = np.repeat([z == zone and off != 0.0 for z, off in ZONES], 12)
    assert inside[near & on].any() and mid[near & on].any(), zone

  for name, a, b in zip(('forces', 'cost'),
                        tsolver._elliptic_forces(*t(*args)),
                        jsolver._elliptic_forces(*j(*args))):
    _close(a, b, ZONE_TOL, name)
  _close(tsolver._elliptic_hess(*t(*args)), jsolver._elliptic_hess(*j(*args)),
         ZONE_TOL, 'hess')
  gh_args = (jx, jdx, xD, mu, fr, act)
  for name, a, b in zip(('g', 'h'), tsolver._elliptic_gh(*t(*gh_args)),
                        jsolver._elliptic_gh(*j(*gh_args))):
    _close(a, b, ZONE_TOL, name)


# ---------------------------------------------------------------------------
# rows and efc_force
# ---------------------------------------------------------------------------


def _mj(xml):
  m = mujoco.MjModel.from_xml_string(xml)
  m.opt.solver = mujoco.mjtSolver.mjSOL_NEWTON
  return m


def _jax_rows(m, d):
  d = jpipe.fwd_velocity(m, jpipe.fwd_position(m, d))
  d = jsmooth.fwd_smooth(m, jsmooth.actuation(m, d))
  efc = jcon.make_efc(m, d)
  return d, efc, jsolver.solve(m, d, efc)


@pytest.mark.parametrize('cap', [None, 6])
@pytest.mark.parametrize('xml', ['mixed', 'condim6'])
def test_rows_and_efc_force_match_jax(xml, cap):
  """At a settled state with the sphere sent sliding, make_efc's blocks
  and the solved qacc, qfrc_constraint and dense efc_force."""
  mj = _mj({'mixed': MIXED_XML, 'condim6': CONDIM6_XML}[xml])
  md = mujoco.MjData(mj)
  for _ in range(150):
    mujoco.mj_step(mj, md)
  md.qvel[0], md.qvel[7] = 0.8, -0.4  # the sphere slides, the box too
  jm = jio.put_model(mj, dtype=jnp.float64, ncon_cap=cap)
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64, ncon_cap=cap)
  s = tm.stat
  assert bool(cap) == bool(s.ncon_cap) and s.cone == 1
  dm = {'mixed': 4, 'condim6': 6}[xml]
  assert tcon.elliptic_dmax(s) == jcon.elliptic_dmax(jm.stat) == dm
  assert tcon.efc_layout(s).nefc == jcon.efc_layout(jm.stat).nefc
  jd = jax_batch(jm, 1, md.qpos[None], md.qvel[None], np.zeros((1, 0)))
  fs, efc, solved = quick_jit(jax.vmap(_jax_rows, in_axes=(None, 0)))(jm, jd)

  tfs = tphys.data_from_numpy(data_leaves(fs), tm)
  tefc = tcon.make_efc(tm, tfs)
  assert {k for k in tefc} <= set(efc) and 'x_J' in tefc
  for k, v in tefc.items():
    _close(v, efc[k], ROW_TOL, f'efc[{k}]')
  assert tefc['x_active'].sum() >= 2  # the sphere's and the box's
  tsolved = tsolver.solve(tm, tfs, tefc)
  for f in ('qacc', 'qfrc_constraint', 'efc_force'):
    _close(getattr(tsolved, f), getattr(solved, f), ROW_TOL, f)
  assert tsolved.efc_force.shape == (1, tcon.efc_layout(s).nefc)
  assert float(tsolved.efc_force.abs().max()) > 1.0


def test_rollout_matches_jax_and_mujoco():
  """140 steps of MIXED_XML from rest (three bodies falling onto the
  plane, condim 1/3/4, anisotropic friction, impratio 1.5; the spheres
  land at steps 51 and 85, the box at 131 and strikes through the last
  steps). MuJoCo alone takes the first 50, a free fall with no contact;
  the three engines start from its state and its warmstart. From there
  the port's qpos against the JAX package's and MuJoCo's every step,
  every body on the plane at the end."""
  mj = _mj(MIXED_XML)
  md = mujoco.MjData(mj)
  for _ in range(FREE_FALL_STEPS):
    mujoco.mj_step(mj, md)
  assert md.ncon == 0
  # copies: MuJoCo steps its buffers in place, and both arrays may alias
  start = {k: np.copy(getattr(md, k))
           for k in ('time', 'qpos', 'qvel', 'qacc_warmstart')}
  jm = jio.put_model(mj, dtype=jnp.float64)
  jd = jio.make_data(jm, dtype=jnp.float64).replace(
      **{k: jnp.asarray(v) for k, v in start.items()})
  jstep = quick_jit(jpipe.step)
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  td = tphys.make_batched_data(tm, 1, device='cpu')
  td = td.replace(**{k: torch.as_tensor(v).reshape(getattr(td, k).shape)
                     for k, v in start.items()})
  err_jax = err_mj = 0.0
  for _ in range(ROLLOUT_STEPS - FREE_FALL_STEPS):
    mujoco.mj_step(mj, md)
    jd = jstep(jm, jd)
    with torch.inference_mode():  # a fifth less op dispatch on the CPU
      td = tpipe.step(tm, td)
    q = td.qpos[0].numpy()
    err_jax = max(err_jax, float(np.abs(q - np.asarray(jd.qpos)).max()))
    err_mj = max(err_mj, float(np.abs(q - md.qpos).max()))
  assert err_jax <= ROLLOUT_TOL and err_mj <= ROLLOUT_TOL, (err_jax, err_mj)
  on = {int(mj.geom_bodyid[g]) for c in md.contact[:md.ncon]
        for g in (c.geom1, c.geom2)}
  assert on == {0, 1, 2, 3}, on  # every body on the plane


def test_contacts_disabled_gives_the_empty_block():
  """With contacts disabled an elliptic model solves `_empty_elliptic`'s
  one-slot block, which the dense efc_force does not take: two steps are
  MuJoCo's free fall."""
  mj = _mj(MIXED_XML)
  assert not tcon.elliptic_block_empty(
      tphys.put_model(mj, device='cpu', dtype=torch.float64).stat)
  mj.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_CONTACT
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  assert tm.stat.cone == 1 and tcon.elliptic_block_empty(tm.stat)
  md = mujoco.MjData(mj)
  td = tphys.make_batched_data(tm, 1, device='cpu')
  for _ in range(2):
    mujoco.mj_step(mj, md)
    td = tpipe.step(tm, td)
  _close(td.qpos[0], md.qpos, ROLLOUT_TOL, 'qpos')
  assert td.efc_force.shape == (1, tcon.efc_layout(tm.stat).nefc)
  assert not td.efc_force.any()


# ---------------------------------------------------------------------------
# the option on a snapshot, and the env
# ---------------------------------------------------------------------------


def test_snapshot_takes_the_cone_as_the_compile_does():
  """The G1 flat scene compiled with cone='elliptic' is the committed
  snapshot with the velocity cfg's options (the cone elliptic) written in
  by MujocoCfg.apply, field by field; the engine's Models equal."""
  from mjlab_torch.tasks import registry as treg
  cfg = treg.load_cfg('Mjlab-Velocity-Flat-Unitree-G1').sim.mujoco
  cfg.cone = 'elliptic'
  got = cfg.apply(g1_flat_arrays())
  spec = flat_scene_spec(robot_spec())
  spec.option.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  mj = spec.compile()
  a, b = got.arrays(), tio.ModelArrays.of(mj).arrays()
  assert sorted(a) == sorted(b)
  for k in a:
    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  assert int(a['opt.cone']) == 1
  cfg.check_model(mj)
  tm = tphys.put_model(got, device='cpu')
  wm = tphys.put_model(mj, device='cpu')
  assert tm.stat == wm.stat and tm.stat.cone == 1
  # the snapshot itself is not edited
  assert int(g1_flat_arrays().arrays()['opt.cone']) == 0


@functools.lru_cache(maxsize=1)
def _tiny_elliptic():
  return _pair(FLAT, cone='elliptic')


def test_six_env_steps_of_flat_tiny_elliptic_match_jax():
  jenv, tenv = _tiny_elliptic()
  s = tenv.model.stat
  assert s.cone == 1 and tcon.elliptic_dmax(s) == 3
  assert 'geom_friction' in tenv.per_env_fields
  fired = six_env_steps(jenv, tenv)
  assert fired[2] == [False, True, False], fired
  assert tenv.state.data.efc_force.shape[1] == tcon.efc_layout(s).nefc
