"""Parity of the port's physics step with the JAX package on the G1 flat
model (the velocity env's own MjModel), float64, at states dropped onto the
floor so contacts are active: collision, constraint assembly, the Newton
solve and the contact sensors stage by stage, one full step, and a
20-substep rollout; and one step of the same model with the elliptic
friction cone and per-env foot friction. Both engines get the same model
and state, carried across as numpy leaves."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import collision as jcol
from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import pipeline as jpipe
from mjlab_tpu.physics import sensor as jsen
from mjlab_tpu.physics import smooth as jsmooth
from mjlab_tpu.physics import smooth_fused as jsf
from mjlab_tpu.physics import solver as jsolver
import mjlab_torch.physics as tphys
from mjlab_torch.physics import collision as tcol
from mjlab_torch.physics import constraint as tcon
from mjlab_torch.physics import sensor as tsen
from mjlab_torch.physics import solver as tsolver
from torch_parity import data_leaves, g1_flat_mjmodel, g1_states, jax_batch
from torch_parity import model_leaves, quick_jit, to_port

N = 3
STAGE_TOL = 1e-9  # float64; the same formulas in another summation order
ROLLOUT_TOL = 1e-6  # 20 substeps of contact dynamics amplify roundoff


@pytest.fixture(scope='module')
def setup():
  mj = g1_flat_mjmodel()
  jm = jio.put_model(mj, dtype=jnp.float64)
  jd = jax_batch(jm, N, *g1_states(mj, N, seed=0, drop=0.03))
  tm, td = to_port(jm, jd, mj)
  return mj, jm, jd, tm, td


def _stages(m, d):
  """The JAX substep up to sensors, keeping each stage's input."""
  pre = jsf._xla_all(m, d)
  col = jcol.collision(m, pre)
  d = jpipe.fwd_velocity(m, jpipe.fwd_position(m, d))
  d = jsmooth.fwd_smooth(m, jsmooth.actuation(m, d))
  efc = jcon.make_efc(m, d)
  solved = jsolver.solve(m, d, efc)
  return pre, col, d, efc, solved, jsen.sensors(m, solved)


@functools.cache
def _jax_stages():
  return jax.jit(jax.vmap(_stages, in_axes=(None, 0)))


@functools.cache
def _jax_step():
  return jax.jit(jax.vmap(jpipe.step, in_axes=(None, 0)))


def _port(tm, jd):
  return tphys.data_from_numpy(data_leaves(jd), tm)


def _close(got, want, tol, what):
  np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                             np.asarray(want), rtol=0, atol=tol,
                             err_msg=what)


def test_stages_match_jax(setup):
  _, jm, jd, tm, _ = setup
  pre, col, fs, efc, solved, sensed = _jax_stages()(jm, jd)

  got = tcol.collision(tm, _port(tm, pre))
  for f in ('dist', 'pos', 'frame', 'friction', 'solref', 'solimp',
            'includemargin'):
    _close(getattr(got.contact, f), getattr(col.contact, f), STAGE_TOL,
           f'contact.{f}')
  np.testing.assert_array_equal(got.ncon_active.numpy(),
                                np.asarray(col.ncon_active))

  tfs = _port(tm, fs)
  tefc = tcon.make_efc(tm, tfs)
  assert tefc['c_active'].any(-1).all(), 'every env needs active contacts'
  for k, v in tefc.items():
    _close(v if v.dtype != torch.bool else v.numpy(), efc[k], STAGE_TOL,
           f'efc[{k}]')

  tsolved = tsolver.solve(tm, tfs, tefc)
  for f in ('qacc', 'qfrc_constraint', 'efc_force'):
    _close(getattr(tsolved, f), getattr(solved, f), STAGE_TOL, f)

  tsensed = tsen.sensors(tm, _port(tm, solved))
  _close(tsensed.sensordata, sensed.sensordata, 0.0, 'sensordata')
  assert np.asarray(sensed.sensordata).min() > 0  # both feet touch down


def test_step_matches_jax(setup):
  _, jm, jd, tm, td = setup
  want = _jax_step()(jm, jd)
  got = tphys.step(tm, td)
  for f in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata'):
    _close(getattr(got, f), getattr(want, f), STAGE_TOL, f)
  # the port's own entry points build the same model
  own = tphys.put_model(setup[0], device='cpu', dtype=torch.float64)
  _close(tphys.step(own, td).qpos, want.qpos, STAGE_TOL, 'qpos (own model)')


def test_rollout_matches_jax(setup):
  _, jm, jd, tm, td = setup
  step = _jax_step()
  for _ in range(20):
    jd = step(jm, jd)
    td = tphys.step(tm, td)
  for f in ('qpos', 'qvel', 'sensordata'):
    _close(getattr(td, f), getattr(jd, f), ROLLOUT_TOL, f)


def _wrenched(mj, jd, seed=7):
  """`jd` with a random wrench on every body but the world: force uniform
  in [-20, 20] N, torque in [-5, 5] N m (the ranges chip_smoke.py puts on
  the G1's torso)."""
  rng = np.random.default_rng(seed)
  x = np.zeros(jd.xfrc_applied.shape)
  x[:, 1:, :3] = rng.uniform(-20.0, 20.0, (N, mj.nbody - 1, 3))
  x[:, 1:, 3:] = rng.uniform(-5.0, 5.0, (N, mj.nbody - 1, 3))
  return jd.replace(xfrc_applied=jnp.asarray(x))


def test_step_with_a_wrench_matches_jax(setup):
  """One step with a random nonzero xfrc_applied: the wrench reaches
  qfrc_smooth (xfrc_accumulate), the SPD solve of qacc_smooth and the
  Newton solve, as in the JAX step."""
  mj, jm, jd, tm, _ = setup
  jw = _wrenched(mj, jd)
  want = _jax_step()(jm, jw)
  got = tphys.step(tm, _port(tm, jw))
  for f in ('qfrc_smooth', 'qacc_smooth', 'qpos', 'qvel', 'qacc',
            'efc_force', 'sensordata'):
    _close(getattr(got, f), getattr(want, f), STAGE_TOL, f)
  # the wrench moves the step
  still = _jax_step()(jm, jd)
  assert np.abs(np.asarray(want.qacc_smooth)
                - np.asarray(still.qacc_smooth)).max() > 1.0


def test_densify_efc_matches_jax(setup):
  """The dense efc views of the dropped G1 states (friction, joint-limit
  and contact rows) in MuJoCo's row order, against the JAX package's
  densify_efc of its own blocks; efc_force takes the same rows."""
  _, jm, jd, tm, _ = setup
  _, _, fs, efc, solved, _ = _jax_stages()(jm, jd)
  want = jax.vmap(lambda e: jcon.densify_efc(jm.stat, e))(efc)
  tefc = tcon.make_efc(tm, _port(tm, fs))
  got = tcon.densify_efc(tm.stat, tefc)
  assert set(got) == set(want)
  for k, v in got.items():
    _close(v if v.dtype != torch.bool else v.numpy(), want[k], STAGE_TOL,
           f'dense {k}')
  lay = tcon.efc_layout(tm.stat)
  nefc = np.asarray(solved.efc_force).shape[-1]
  assert got['J'].shape == (N, lay.nefc, tm.stat.nv) and nefc == lay.nefc
  assert lay.ne == 0 and lay.nl > 0 and lay.ncr > 0
  # friction rows: the identity; limit rows: one-sided; contacts active
  nv = tm.stat.nv
  assert torch.equal(got['J'][:, :nv], torch.eye(nv, dtype=torch.float64)
                     .expand(N, nv, nv))
  assert got['oneside'][:, nv:].all() and not got['oneside'][:, :nv].any()
  assert got['active'][:, nv + lay.nl:].any(-1).all()


def test_densify_efc_elliptic_matches_jax(setup):
  """The dense views of the elliptic G1's blocks (the x block of the
  compacted frictional slots scattered to their rows, the frictionless
  pool's c rows), against the JAX densify_efc of the same blocks env by
  env (eager: no program is compiled)."""
  import mujoco
  mj, _, jd, _, _ = setup
  mje = copy.copy(mj)
  mje.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  tm = tphys.put_model(mje, device='cpu', dtype=torch.float64)
  td = _port(tm, jd)
  efc = tcon.make_efc(tm, tphys.pipeline.fwd_velocity(
      tm, tphys.pipeline.fwd_position(tm, td)))
  assert efc['x_active'].any(-1).all()
  got = tcon.densify_efc(tm.stat, efc)
  jstat = jio.put_model(mje, dtype=jnp.float64).stat
  for b in range(N):
    one = {k: jnp.asarray(v[b].numpy()) for k, v in efc.items()}
    # the JAX blocks always hold an equality block (here empty)
    for k, dtype in (('e_J', None), ('e_D', None), ('e_aref', None),
                     ('e_pos', None), ('e_active', bool)):
      shape = (1, tm.stat.nv) if k == 'e_J' else (1,)
      one.setdefault(k, jnp.zeros(shape, dtype or jnp.float64))
    want = jcon.densify_efc(jstat, one)
    assert set(got) == set(want)
    for k, v in got.items():
      _close(v[b] if v.dtype != torch.bool else v[b].numpy(), want[k],
             STAGE_TOL, f'env {b} dense {k}')
  lay = tcon.efc_layout(tm.stat)
  assert got['active'][:, lay.con_row0:].any(-1).all()


def test_elliptic_step_with_per_env_foot_friction_matches_jax(setup):
  """The G1 flat model with cone='elliptic' (the x block of its 32
  compacted frictional slots, the frictionless pool in the c block, the
  plain Newton with the elliptic Hessian blocks) and the feet's sliding
  friction set per env, one step from the dropped states."""
  import mujoco

  from mjlab_tpu.sim.sim import expand_model_fields, model_vmap_axes
  mj, _, jd, _, _ = setup
  mje = copy.copy(mj)
  mje.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  base = jio.put_model(mje, dtype=jnp.float64)
  jm = expand_model_fields(base, ['geom_friction'], N)
  feet = np.nonzero(mje.geom_condim == 3)[0]
  fr = np.asarray(jm.geom_friction).copy()
  fr[:, feet, 0] = np.array([0.4, 0.6, 0.9])[:N, None]
  jm = jm.replace(geom_friction=jnp.asarray(fr))
  step = quick_jit(jax.vmap(jpipe.step,
                            in_axes=(model_vmap_axes(jm, base), 0)))
  want = step(jm, jd)
  stat = tphys.put_model(mje, device='cpu', dtype=torch.float64).stat
  assert stat.cone == 1 and stat.ncon_cap == 32
  tm = tphys.model_from_numpy(model_leaves(jm), stat, device='cpu',
                              dtype=torch.float64)
  td = _port(tm, jd)
  efc = tcon.make_efc(tm, tphys.pipeline.fwd_velocity(
      tm, tphys.pipeline.fwd_position(tm, td)))
  assert efc['x_active'].any(-1).all()  # every env's feet touch down
  # the per-env friction reaches the cone's coefficient
  assert len(set(efc['x_mu'][efc['x_active']].tolist())) >= N
  got = tphys.step(tm, td)
  for f in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata'):
    _close(getattr(got, f), getattr(want, f), STAGE_TOL, f)


SMALL = """
<mujoco>
  <option timestep="0.002" integrator="{integrator}"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="base" pos="0 0 0.15">
      <freejoint/>
      <geom type="capsule" fromto="-0.1 0 0 0.1 0 0" size="0.05" mass="2"/>
      <body name="leg" pos="0.1 0 0">
        <joint name="hip" type="hinge" axis="0 1 0" range="-1 1"
               damping="0.2" armature="0.01" frictionloss="0.05"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.1" size="0.03" mass="0.4"/>
        <geom name="foot" type="sphere" pos="0 0 -0.12" size="0.04"
              mass="0.1" condim="1" priority="1"/>
      </body>
      <body name="leg2" pos="0.1 0.08 0">
        <joint name="hip2" type="slide" axis="0 0 1" range="-0.05 0.05"/>
        <geom type="capsule" fromto="0 0 0 0 0 -0.1" size="0.03" mass="0.4"/>
      </body>
      <body name="arm" pos="-0.1 0 0">
        <joint name="shoulder" type="hinge" axis="1 0 0" range="-0.5 0.5"/>
        <geom type="sphere" pos="0 0 -0.1" size="0.05" mass="0.3"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="hip" kp="20" kv="1" ctrlrange="-1 1"
              forcerange="-10 10"/>
    <general joint="shoulder" dyntype="filterexact" dynprm="0.05"
             gainprm="2" ctrlrange="-1 1" ctrllimited="true"/>
    <general joint="hip2" dyntype="integrator" gainprm="50"
             biastype="affine" biasprm="0 -50 -2" actlimited="true"
             actrange="-0.04 0.04"/>
  </actuator>
  <sensor>
    <contact geom1="foot" geom2="floor" data="found" reduce="none" num="2"/>
    <contact body1="base" data="found" reduce="mindist"/>
  </sensor>
</mujoco>
"""


def test_small_scene_rollout_matches_jax():
  """Every candidate contact builds rows (a small pair table takes no
  compaction), all five implemented colliders, a frictionless contact, a
  slide joint, joint limits, friction loss, filterexact and integrator
  activation states, and the Euler integrator (the G1 tests above cover
  implicitfast)."""
  import mujoco
  mj = mujoco.MjModel.from_xml_string(SMALL.format(integrator='Euler'))
  jm = jio.put_model(mj, dtype=jnp.float64)
  assert jm.stat.ncon_cap == 0 and jm.stat.pairs.ncon_max > 0
  rng = np.random.default_rng(0)
  n = 2
  qpos = np.tile(mj.qpos0, (n, 1))
  qpos[:, 7:] += 0.2 * rng.normal(size=(n, mj.nq - 7))
  qvel = 0.3 * rng.normal(size=(n, mj.nv))
  jd = jax_batch(jm, n, qpos, qvel, rng.normal(size=(n, mj.nu)))
  tm, td = to_port(jm, jd, mj)
  step = jax.jit(jax.vmap(jpipe.step, in_axes=(None, 0)))
  for _ in range(5):
    jd = step(jm, jd)
    td = tphys.step(tm, td)
  assert np.asarray(jd.ncon_active).min() > 0
  for f in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata', 'act',
            'act_dot'):
    _close(getattr(td, f), getattr(jd, f), STAGE_TOL, f)
  assert np.abs(np.asarray(jd.act)).min() > 0
