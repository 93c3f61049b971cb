"""Parity of the port's sensors with the JAX package, float64 on the CPU:
every sensor type of the sensor robot (mjlab_torch/asset_zoo/
oracle_models.py, the MJCF of tests/test_physics_step.py with one foot
contact sensor added) under Euler and implicitfast, against the JAX
engine and MuJoCo; and the contact sensor in every data field and reduce
mode, with the touch sensor, on boxes, a ball and a rod on the floor,
pyramidal and elliptic, with all contact slots and compacted."""

import functools

import jax
import mujoco
import numpy as np
import pytest

from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import pipeline as jpipe
import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import oracle_models as om
from torch_parity import assert_close, jax_batch, oracle_pair, quick_jit
from torch_parity import to_port

N = 3
TOL = 1e-9


@functools.cache
def _jax(fn):
  return quick_jit(jax.vmap(fn, in_axes=(None, 0)))


def _robot_state(mj, seed):
  """Env 0 in the air (the JAX test's state), envs 1-2 with the foot on
  the floor."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (N, 1))
  qpos[:, 2] += np.asarray([0.2, 0.0, 0.005])
  qpos[:, 7:] += rng.uniform(-0.2, 0.2, (N, mj.nq - 7))
  qvel = rng.uniform(-1.0, 1.0, (N, mj.nv))
  ctrl = np.tile([0.4, -0.5], (N, 1)) + rng.uniform(-0.2, 0.2, (N, 2))
  return qpos, qvel, ctrl


def _quat_sign(mj, ours, theirs):
  """theirs with each framequat's sign chosen as ours' (q and -q are one
  rotation)."""
  theirs = theirs.copy()
  for i in np.nonzero(mj.sensor_type == mujoco.mjtSensor.mjSENS_FRAMEQUAT)[0]:
    a = mj.sensor_adr[i]
    flip = (ours[..., a:a + 4] * theirs[..., a:a + 4]).sum(-1) < 0
    theirs[..., a:a + 4] *= np.where(flip, -1.0, 1.0)[..., None]
  return theirs


@pytest.mark.parametrize('integrator', ['Euler', 'implicitfast'])
def test_robot_sensors_match_jax_and_mujoco(integrator):
  """Every sensor type of the robot after one forward, and after 20
  steps."""
  mj = om.compile_model(om.robot_xml(integrator))
  assert mj.nsensor == 12
  qpos, qvel, ctrl = _robot_state(mj, 7)
  jm, jd, tm, td = oracle_pair(mj, qpos, qvel, ctrl)
  got = tphys.forward(tm, td).sensordata.numpy()
  assert_close(got, _jax(jpipe.forward)(jm, jd).sensordata, TOL,
               'sensordata')
  found = mj.sensor_adr[11]
  assert got[0, found] == 0 and (got[1:, found] == 1).all()
  for e in range(N):
    md = mujoco.MjData(mj)
    md.qpos[:], md.qvel[:], md.ctrl[:] = qpos[e], qvel[e], ctrl[e]
    mujoco.mj_forward(mj, md)
    assert_close(got[e], _quat_sign(mj, got[e], md.sensordata), 1e-8,
                 f'sensordata against MuJoCo, env {e}')
  step = _jax(jpipe.step)
  for _ in range(20):
    jd = step(jm, jd)
    td = tphys.step(tm, td)
  assert_close(td.sensordata, jd.sensordata, TOL, 'sensordata, 20 steps')


CONTACT_XML = """
<mujoco>
  <option timestep="0.002" cone="{cone}"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 .1"/>
    <body name="box" pos="0 0 0.049" euler="3 2 0">
      <freejoint/>
      <geom name="boxg" type="box" size=".1 .08 .05" mass="1"/>
      <site name="boxsite"/>
      <body name="lid" pos="0 0 0.07">
        <joint type="hinge" axis="1 0 0" damping="0.1"/>
        <geom name="lidg" type="box" size=".05 .05 .02" mass="0.2"/>
      </body>
    </body>
    <body name="ball" pos="0.4 0 0.098">
      <freejoint/>
      <geom name="ballg" type="sphere" size="0.1" mass="0.5" condim="1"/>
    </body>
    <body name="rod" pos="-0.4 0 0.039" euler="0 90 10">
      <freejoint/>
      <geom name="rodg" type="capsule" size="0.04 0.15" mass="0.3"
            condim="6"/>
      <site name="rodsite"/>
    </body>
  </worldbody>
  <sensor>
    <contact name="box_none" body1="box"
             data="found force torque dist pos normal tangent" num="3"/>
    <contact name="box_min" geom1="boxg" geom2="floor"
             data="found dist pos normal" reduce="mindist"/>
    <contact name="box_max" geom1="floor" geom2="boxg"
             data="force tangent" reduce="maxforce"/>
    <contact name="tree_net" subtree1="box"
             data="found force torque dist pos normal tangent"
             reduce="netforce"/>
    <contact name="ball_none" geom1="ballg" data="found force dist" num="2"/>
    <contact name="rod_net" body1="rod" data="found force torque"
             reduce="netforce"/>
    <touch site="boxsite"/>
    <touch site="rodsite"/>
  </sensor>
</mujoco>"""


@pytest.mark.parametrize('compact', [0, 6], ids=['all_slots', 'compacted'])
@pytest.mark.parametrize('cone', ['pyramidal', 'elliptic'])
def test_contact_sensors_match_jax(cone, compact):
  mj = om.compile_model(CONTACT_XML.format(cone=cone))
  rng = np.random.default_rng(3)
  qpos = np.tile(mj.qpos0, (N, 1))
  qpos[:, 2] += np.asarray([0.0, -0.002, 0.3])  # env 2's box in the air
  qvel = rng.uniform(-0.3, 0.3, (N, mj.nv))
  jm = jio.put_model(mj, dtype=jax.numpy.float64, ncon_cap=compact or None)
  jd = jax_batch(jm, N, qpos, qvel, np.zeros((N, mj.nu)))
  tm, td = to_port(jm, jd, mj, ncon_cap=compact or None)
  assert (tm.stat.ncon_cap + tm.stat.ncon_cap1 > 0) == bool(compact)
  got = tphys.forward(tm, td).sensordata
  assert_close(got, _jax(jpipe.forward)(jm, jd).sensordata, TOL,
               'sensordata')
  found = got[:, mj.sensor_adr[0]].numpy()
  assert found[0] > 0 and found[2] == 0  # the box's contacts, then none
