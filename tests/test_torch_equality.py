"""Parity of the port's equality constraints (connect, weld, joint) and
mocap bodies with the JAX package, float64 on the CPU, on the engine's
oracle models (mjlab_torch/asset_zoo/oracle_models.py, the MJCF of
tests/test_equality.py): the equality rows of make_efc, one forward, a
100-step rollout, each on a batch of 3 envs in different states against
the vmapped JAX engine; the closed chain and a model with contact pairs
under the elliptic cone; a welded box following a moving mocap target;
mocap kinematics; the refusal of other equality types."""

import functools

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import kinematics as jkin
from mjlab_tpu.physics import pipeline as jpipe
from mjlab_tpu.physics import smooth as jsmooth
import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import oracle_models as om
from mjlab_torch.physics import constraint as tcon
from mjlab_torch.physics import kinematics as tkin
from torch_parity import assert_close, oracle_pair, port_data, quick_jit

N = 3  # envs, each in its own state
TOL = 1e-9  # rows and one forward, float64
ROLLOUT_TOL = 1e-8  # 100 steps
EQ = ('connect', 'weld', 'joint', 'fourbar')
E_KEYS = ('e_J', 'e_D', 'e_aref', 'e_active', 'e_pos')


def _stages(m, d):
  d = jpipe.fwd_velocity(m, jpipe.fwd_position(m, d))
  d = jsmooth.fwd_smooth(m, jsmooth.actuation(m, d))
  return d, jcon.make_efc(m, d)


@functools.cache
def _jax(fn):
  return quick_jit(jax.vmap(fn, in_axes=(None, 0)))


def _state(mj):
  """N states about qpos0, each its own (as tests/test_equality.py draws
  one)."""
  rng = np.random.default_rng(0)
  qpos = np.tile(mj.qpos0, (N, 1)) + rng.uniform(-0.05, 0.05, (N, mj.nq))
  return qpos, rng.uniform(-0.3, 0.3, (N, mj.nv))


ROWS = {'connect': 3, 'weld': 6, 'joint': 1, 'fourbar': 3}


@pytest.mark.parametrize('name', EQ)
def test_equality_rows_match_jax(name):
  mj = om.oracle_model(name)
  jm, jd, tm, _ = oracle_pair(mj, *_state(mj))
  assert np.ptp(np.asarray(jd.qvel), axis=0).min() > 0  # distinct envs
  fs, efc = _jax(_stages)(jm, jd)
  tefc = tcon.make_efc(tm, port_data(tm, fs))
  assert tefc['e_active'].all() and tefc['e_J'].shape[1] == ROWS[name]
  for k in E_KEYS:
    assert_close(tefc[k], efc[k], TOL, k)


@pytest.mark.parametrize('name', EQ)
def test_forward_and_rollout_match_jax(name):
  """One forward (qacc, efc_force and the constraint force, which a step
  keeps), then 100 steps; the constraint holds."""
  mj = om.oracle_model(name)
  jm, jd, tm, td = oracle_pair(mj, *_state(mj))
  step = _jax(jpipe.step)
  jd = step(jm, jd)
  td = tphys.step(tm, td)
  for f in ('qacc', 'efc_force', 'qfrc_constraint'):
    assert_close(getattr(td, f), getattr(jd, f), TOL, f)
  for _ in range(99):
    jd = step(jm, jd)
    td = tphys.step(tm, td)
  assert_close(td.qpos, jd.qpos, ROLLOUT_TOL, 'qpos')
  assert_close(td.qvel, jd.qvel, ROLLOUT_TOL, 'qvel')
  assert float(tcon.make_efc(tm, tphys.forward(tm, td))['e_pos'].abs().max()
               ) < 1e-2


@pytest.mark.parametrize('name', ['fourbar', 'connect'])
def test_elliptic_cone_matches_jax(name):
  """Under cone='elliptic': the closed chain (no contact pairs) and the two
  boxes (a box-box pair, so the elliptic x block and its Newton carry the
  bilateral rows): one forward, then 10 steps."""
  mj = om.oracle_model(name)
  mj.opt.cone = mujoco.mjtCone.mjCONE_ELLIPTIC
  jm, jd, tm, td = oracle_pair(mj, *_state(mj))
  assert ('x_J' in tcon.make_efc(tm, tphys.forward(tm, td))) == (
      name == 'connect')
  step = _jax(jpipe.step)
  jd = step(jm, jd)
  td = tphys.step(tm, td)
  for f in ('qacc', 'efc_force'):
    assert_close(getattr(td, f), getattr(jd, f), TOL, f)
  for _ in range(9):
    jd = step(jm, jd)
    td = tphys.step(tm, td)
  assert_close(td.qpos, jd.qpos, ROLLOUT_TOL, 'qpos')


def _target(t):
  return np.asarray([0.3 + 0.2 * np.sin(0.02 * t), 0.1,
                     1.2 + 0.1 * np.cos(0.02 * t)])


def test_mocap_weld_follows_a_moving_target():
  """A free box welded to a mocap target that moves on a circle, as
  test_mocap_weld_target_parity: 100 steps against the JAX engine (each
  env's target on its own phase) and against MuJoCo (env 0)."""
  mj = om.oracle_model('mocap_weld')
  md = mujoco.MjData(mj)
  qpos = np.tile(mj.qpos0, (N, 1))
  jm, jd, tm, td = oracle_pair(mj, qpos, np.zeros((N, mj.nv)))
  assert tm.stat.nmocap == 1 and td.mocap_pos.shape == (N, 1, 3)
  assert_close(td.mocap_pos[:, 0], np.tile(mj.body_pos[1], (N, 1)), 0.0,
               'mocap_pos at reset')
  step = _jax(jpipe.step)
  for t in range(100):
    target = np.stack([_target(t + 7 * e) for e in range(N)])[:, None]
    md.mocap_pos[0] = target[0, 0]
    mujoco.mj_step(mj, md)
    jd = step(jm, jd.replace(mocap_pos=jnp.asarray(target)))
    td = tphys.step(tm, td.replace(mocap_pos=torch.as_tensor(target)))
  assert_close(td.qpos, jd.qpos, ROLLOUT_TOL, 'qpos')
  assert_close(td.qpos[0], md.qpos, ROLLOUT_TOL, 'qpos against MuJoCo')
  lag = np.abs(td.qpos[:, 0].numpy() - target[:, 0, 0])
  assert lag.max() < 0.12  # the box follows its target


MOCAP_FK_XML = """
<mujoco>
  <worldbody>
    <body name="m" mocap="true" pos="0.5 0.2 1.0">
      <geom type="sphere" size="0.03" contype="0" conaffinity="0"/>
      <site name="tip" pos="0.1 0 0"/>
    </body>
    <body pos="0 0 1"><freejoint/><geom type="sphere" size="0.1" mass="1"/></body>
    <geom type="plane" size="5 5 .1"/>
  </worldbody>
</mujoco>"""


def test_mocap_kinematics_matches_jax_and_mujoco():
  mj = mujoco.MjModel.from_xml_string(MOCAP_FK_XML)
  md = mujoco.MjData(mj)
  md.mocap_pos[0] = [1.0, -0.5, 2.0]
  md.mocap_quat[0] = [0.7071068, 0.7071068, 0, 0]  # not quite unit
  mujoco.mj_forward(mj, md)
  jm, jd, tm, td = oracle_pair(mj, mj.qpos0[None], np.zeros((1, mj.nv)))
  mp, mq = md.mocap_pos[None].copy(), md.mocap_quat[None].copy()
  want = jax.vmap(jkin.kinematics, in_axes=(None, 0))(
      jm, jd.replace(mocap_pos=jnp.asarray(mp), mocap_quat=jnp.asarray(mq)))
  got = tkin.kinematics(tm, td.replace(mocap_pos=torch.as_tensor(mp),
                                       mocap_quat=torch.as_tensor(mq)))
  for f in ('xpos', 'xquat', 'xmat', 'site_xpos', 'geom_xpos'):
    assert_close(getattr(got, f), getattr(want, f), 1e-12, f)
  assert_close(got.xpos[0, 1], md.xpos[1], 1e-12, 'xpos against MuJoCo')
  assert_close(got.xquat[0, 1], md.xquat[1], 1e-9, 'xquat against MuJoCo')


def test_unsupported_equality_raises():
  """A tendon equality raises at build time in both packages."""
  xml = """
<mujoco>
  <worldbody>
    <body><joint name="s1" type="slide" axis="0 0 1"/>
      <geom type="sphere" size=".05" mass="1"/></body>
  </worldbody>
  <tendon><fixed name="t"><joint joint="s1" coef="1"/></fixed></tendon>
  <equality><tendon tendon1="t"/></equality>
</mujoco>"""
  mj = mujoco.MjModel.from_xml_string(xml)
  with pytest.raises(NotImplementedError):
    jio.put_model(mj)
  with pytest.raises(NotImplementedError, match='equality type 3'):
    tphys.put_model(mj, device='cpu')
