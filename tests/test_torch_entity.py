"""The port's entity layer against the JAX package's on the G1 flat scene:
the static indexing field by field (resolved from the compiled model's name
table, from an MjModel and from its ModelArrays snapshot), every EntityView
read on four random G1 states after `forward` (float64, 1e-9), and every
write, masked and unmasked, which must also leave the Data it was given
untouched."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_tpu.physics import io as jio
from mjlab_tpu.scene.scene import Scene as JScene
from mjlab_tpu.tasks import registry as jreg
from mjlab_torch.entity.entity import compute_indexing
from mjlab_torch.envs.io import _to_numpy
from mjlab_torch.physics.io import CONTACT_FIELDS, DATA_FIELDS, ModelArrays
from mjlab_torch.scene.scene import Scene as TScene
from mjlab_torch.tasks import registry as treg
from torch_parity import G1_FLAT_TASK, g1_states, jax_batch
from torch_parity import jax_data_from_leaves

N = 4
TOL = 1e-9


@pytest.fixture(scope='module')
def pair():
  """(JAX view, port view, JAX Data, port Data): both scenes index the JAX
  scene's compiled model; the Data is the port's `forward` at random
  states, carried across as numpy."""
  jcfg = jreg.load_cfg(G1_FLAT_TASK)
  jscene = JScene(jcfg.scene, dtype=jnp.float64)
  jcfg.sim.mujoco.edit_spec(jscene.spec)
  jm = jscene.initialize()
  mj = jscene.mj_model
  tcfg = treg.load_cfg(G1_FLAT_TASK)
  tscene = TScene(tcfg.scene, mj_model=mj, device='cpu', dtype=torch.float64)
  tm = tscene.initialize()
  qpos, qvel, ctrl = g1_states(mj, N, seed=5, drop=0.03)
  td = tphys.make_batched_data(tm, N, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  td = tphys.forward(tm, td)
  leaves = {k: _to_numpy(getattr(td, k)) for k in DATA_FIELDS}
  leaves['contact'] = {k: _to_numpy(getattr(td.contact, k))
                       for k in CONTACT_FIELDS}
  jd = jax_data_from_leaves(jax_batch(jm, N, qpos, qvel, ctrl), leaves)
  assert float(td.sensordata.max()) > 0, 'a foot should touch the floor'
  return jscene['robot'], tscene['robot'], jd, td, mj


def _same_indexing(got, want):
  for f in dataclasses.fields(want):
    a, b = getattr(got, f.name), getattr(want, f.name)
    if isinstance(b, np.ndarray):
      np.testing.assert_array_equal(a, b, err_msg=f.name)
      assert a.dtype == b.dtype, f.name
    else:
      assert a == b, f.name


@pytest.mark.parametrize('source', ['MjModel', 'ModelArrays'])
def test_indexing_matches_jax(pair, source):
  jview, _, _, _, mj = pair
  model = mj if source == 'MjModel' else ModelArrays.of(mj)
  got = compute_indexing(model, 'robot/')
  _same_indexing(got, jview.idx)
  assert len(got.joint_names) == 29 and len(got.body_names) == 30
  # every geom but the terrain is the robot's, visual meshes included
  assert len(got.geom_ids) == mj.ngeom - 1
  with pytest.raises(KeyError, match='not on entity'):
    pair[1].sensor_data(pair[3], 'no_such_sensor')


def test_view_constants_match_jax(pair):
  jview, tview, *_ = pair
  for name in ('default_root_state', 'default_joint_pos', 'default_joint_vel',
               'joint_pos_limits', 'soft_joint_pos_limits', 'joint_stiffness',
               'joint_damping', 'joint_effort_limits'):
    np.testing.assert_allclose(getattr(tview, name).numpy(),
                               np.asarray(getattr(jview, name)), rtol=0,
                               atol=1e-12, err_msg=name)
  assert tview.is_fixed_base == jview.is_fixed_base
  assert tview.is_articulated and tview.is_actuated


FEET = np.array([6, 12], np.int32)  # entity-order ids of the ankle roll links
READS = [
    ('root_pos_w', ()), ('root_quat_w', ()), ('root_vel_w', ()),
    ('root_lin_vel_w', ()), ('root_ang_vel_w', ()), ('root_lin_vel_b', ()),
    ('root_ang_vel_b', ()), ('projected_gravity_b', ()), ('heading_w', ()),
    ('joint_pos', ()), ('joint_vel', ()), ('joint_acc', ()),
    ('actuator_force', ()), ('applied_torque', ()),
    ('body_pos_w', ()), ('body_pos_w', (FEET,)), ('body_quat_w', ()),
    ('body_quat_w', (FEET,)), ('body_vel_w', ()), ('body_vel_w', (FEET,)),
    ('body_lin_vel_w', (FEET,)), ('body_ang_vel_w', ()),
    ('body_ang_vel_w', (FEET,)), ('geom_pos_w', ()),
    ('geom_pos_w', (np.array([0, 5, 9], np.int32),)), ('site_pos_w', ()),
    ('site_pos_w', (slice(None),)),
    ('sensor_data', ('left_foot_ground_contact',)),
    ('sensor_data', ('right_foot_ground_contact',)),
]


@pytest.mark.parametrize('name,args', READS,
                         ids=[f'{n}{len(a)}' for n, a in READS])
def test_read_matches_jax(pair, name, args):
  jview, tview, jd, td, _ = pair
  want = np.asarray(getattr(jview, name)(jd, *args))
  got = getattr(tview, name)(td, *args)
  assert got.shape == want.shape
  assert np.abs(want).max() > 0, 'a read of zeros holds nothing'
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _write_args(name, rng):
  r = lambda *s: rng.normal(size=s)
  sub = np.array([2, 7, 20], np.int32)
  return {
      'write_root_pose': ((r(N, 7),), {}),
      'write_root_velocity': ((r(N, 6),), {}),
      'write_root_state': ((r(N, 13),), {}),
      'write_joint_state': ((r(N, 29), r(N, 29)), {}),
      'write_joint_state_subset': ((r(N, 3), r(N, 3)), {'joint_ids': sub}),
      'write_joint_position_target': ((r(N, 29),), {}),
      'write_joint_position_target_subset': ((r(N, 3),), {'joint_ids': sub}),
      'write_external_wrench': ((r(N, 30, 3), r(N, 30, 3)), {}),
      'write_external_wrench_subset': ((r(N, 2, 3), r(N, 2, 3)),
                                       {'body_ids': FEET}),
      'reset': ((), {}),
  }[name]


WRITES = ['write_root_pose', 'write_root_velocity', 'write_root_state',
          'write_joint_state', 'write_joint_state_subset',
          'write_joint_position_target', 'write_joint_position_target_subset',
          'write_external_wrench', 'write_external_wrench_subset', 'reset']
WRITTEN = ('qpos', 'qvel', 'ctrl', 'xfrc_applied')


@pytest.mark.parametrize('masked', [False, True], ids=['all', 'masked'])
@pytest.mark.parametrize('name', WRITES)
def test_write_matches_jax(pair, name, masked):
  jview, tview, jd, td, _ = pair
  rng = np.random.default_rng(7)
  args, kw = _write_args(name, rng)
  method = name.replace('_subset', '')
  # `reset` clears forces: give it some to clear
  xfrc = rng.normal(size=td.xfrc_applied.shape)
  jd = jd.replace(xfrc_applied=jnp.asarray(xfrc))
  td = td.replace(xfrc_applied=torch.as_tensor(xfrc))
  mask = np.array([True, False, False, True]) if masked else None
  before = {f: getattr(td, f).clone() for f in WRITTEN}
  want = getattr(jview, method)(
      jd, *[jnp.asarray(a) for a in args], **kw,
      mask=None if mask is None else jnp.asarray(mask))
  got = getattr(tview, method)(
      td, *[torch.as_tensor(a) for a in args], **kw,
      mask=None if mask is None else torch.as_tensor(mask))
  changed = False
  for f in WRITTEN:
    np.testing.assert_array_equal(getattr(got, f).numpy(),
                                  np.asarray(getattr(want, f)), err_msg=f)
    assert torch.equal(getattr(td, f), before[f]), f'{f} written in place'
    changed |= not torch.equal(getattr(got, f), before[f])
  assert changed
  if masked:
    for f in WRITTEN:
      assert torch.equal(getattr(got, f)[1:3], before[f][1:3]), f
