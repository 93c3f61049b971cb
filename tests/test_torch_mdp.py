"""Every MDP term of the port against the JAX package's on the same EnvCtx
contents (G1 flat velocity task, 4 envs, float64, 1e-9): observation, reward
and termination terms one by one, the reset and interval events and
`randomize_field` with point ranges (so no value depends on a draw) on
every field of FIELD_SPECS, the command term and the managers' own
arithmetic; and the engine's per-env `geom_friction`: `_mix_params` with an
env axis against the JAX `vmap`, and bit-equal to the shared path where
every env has the same friction."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.managers import managers as jman
from mjlab_tpu.managers import term_cfg as jtc
from mjlab_tpu.physics import collision as jcol
from mjlab_tpu.sim.sim import expand_model_fields as jexpand
from mjlab_tpu.tasks.velocity import mdp as jmdp
from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.envs.mdp import events as tevents
from mjlab_torch.managers import managers as tman
from mjlab_torch.managers import term_cfg as ttc
from mjlab_torch.physics import collision as tcol
from mjlab_torch.sim.sim import MujocoCfg, expand_model_fields
from mjlab_torch.tasks.velocity import mdp as tmdp
from mjlab_torch.tasks.velocity.config.g1.flat_env_cfg import G1_POSE_STD
from torch_parity import g1_env_pair, jax_state_from_leaves

N = 4
TOL = 1e-9
MASK = np.array([True, False, True, False])
FOOT_SENSORS = ('left_foot_ground_contact', 'right_foot_ground_contact')
KEY = jax.random.PRNGKey(0)


def _gen():
  return torch.Generator().manual_seed(0)


@pytest.fixture(scope='module')
def pair():
  """(JAX env, port env, JAX state, port state): the port env is reset and
  stepped three times under random actions, one joint is pushed past its
  soft limit, and the state is carried across as numpy."""
  jenv, tenv = g1_env_pair(N)
  tenv.reset()
  rng = np.random.default_rng(0)
  for _ in range(3):
    tenv.step(torch.as_tensor(0.5 * rng.normal(size=(N, 29))))
  ts = tenv.state
  view = tenv.scene['robot']
  qpos = ts.data.qpos.clone()
  qpos[0, view.idx.q_adr[3]] = view.soft_joint_pos_limits[3, 1] + 0.1
  qpos[2, view.idx.q_adr[9]] = view.soft_joint_pos_limits[9, 0] - 0.2
  ts = ts.replace(
      data=ts.data.replace(qpos=qpos),
      episode_length=torch.tensor([5, 1000, 3, 999], dtype=torch.int32))
  js = jax_state_from_leaves(jenv, env_state_to_numpy(ts, tenv))
  assert float(ts.data.sensordata.max()) > 0
  return jenv, tenv, js, ts


def _ctxs(pair):
  jenv, tenv, js, ts = pair
  jctx, tctx = jenv._make_ctx(js), tenv._make_ctx(ts)
  flags = np.array([True, False, False, True])
  jctx.terminated, tctx.terminated = jnp.asarray(flags), torch.as_tensor(flags)
  return jctx, tctx


def _entity(**kw):
  """A SceneEntityCfg to build in each package: ('entity', kwargs)."""
  return ('entity', kw)


def _params(tc, man, scene, func, params):
  """Params as a manager resolves them (SceneEntityCfgs given and
  defaulted), in one package."""
  made = {k: (tc.SceneEntityCfg('robot', **v[1])
              if isinstance(v, tuple) and v and v[0] == 'entity' else v)
          for k, v in params.items()}
  return man._resolve_params(made, scene, func)


def _both(pair, name, params, state=None):
  """Call term `name` of the velocity task's mdp namespace in both
  packages on the shared context."""
  jenv, tenv, _, _ = pair
  jctx, tctx = _ctxs(pair)
  jf, tf = getattr(jmdp, name), getattr(tmdp, name)
  jp = _params(jtc, jman, jenv.scene, jf, params)
  tp = _params(ttc, tman, tenv.scene, tf, params)
  if state is None:
    return jf(jctx, **jp), tf(tctx, **tp)
  jstate = {k: jnp.asarray(v) for k, v in state.items()}
  tstate = {k: torch.as_tensor(v) for k, v in state.items()}
  return jf(jctx, jstate, **jp), tf(tctx, tstate, **tp)


def _close(got, want, what='', tol=TOL):
  got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


SOME_JOINTS = _entity(joint_names=['.*_knee_joint', 'waist.*'])
FEET = _entity(body_names=['.*_ankle_roll_link'])
TERMS = {
    # observations
    'base_lin_vel': {}, 'base_ang_vel': {}, 'projected_gravity': {},
    'root_pos_w': {}, 'root_quat_w': {},
    'joint_pos_rel': {}, 'joint_vel_rel': {},
    'joint_pos_rel/some': ('joint_pos_rel', {'asset_cfg': SOME_JOINTS}),
    'joint_vel_rel/some': ('joint_vel_rel', {'asset_cfg': SOME_JOINTS}),
    'joint_pos': {'asset_cfg': SOME_JOINTS},
    'joint_vel': {'asset_cfg': SOME_JOINTS},
    'last_action': {}, 'generated_commands': {'command_name': 'twist'},
    # rewards
    'is_alive': {}, 'is_terminated': {}, 'joint_torques_l2': {},
    'joint_acc_l2': {'asset_cfg': SOME_JOINTS},
    'joint_vel_l2': {'asset_cfg': SOME_JOINTS},
    'joint_vel_l2/all': ('joint_vel_l2', {}),
    'action_rate_l2': {}, 'action_l2': {}, 'joint_pos_limits': {},
    'joint_pos_limits/some': ('joint_pos_limits', {'asset_cfg': SOME_JOINTS}),
    'flat_orientation_l2': {}, 'electrical_power_cost': {},
    'posture': {'std': G1_POSE_STD,
                'asset_cfg': _entity(joint_names=['.*'])},
    'upright': {},
    'track_lin_vel_exp': {'std': 0.5, 'command_name': 'twist'},
    'track_ang_vel_exp': {'std': 0.5, 'command_name': 'twist'},
    'feet_slide': {'sensor_names': FOOT_SENSORS, 'asset_cfg': FEET},
    'foot_clearance_reward': {'asset_cfg': FEET, 'target_height': 0.1,
                              'std': 0.05},
    # terminations
    'time_out': {},
    'bad_orientation': {'limit_angle': math.radians(70.0)},
    'bad_orientation/tight': ('bad_orientation', {'limit_angle': 0.01}),
    'root_height_below_minimum': {'minimum_height': 0.74},
}


@pytest.mark.parametrize('case', list(TERMS))
def test_term_matches_jax(pair, case):
  spec = TERMS[case]
  name, params = spec if isinstance(spec, tuple) else (case, spec)
  want, got = _both(pair, name, params)
  _close(got, want, case)
  assert got.shape[0] == N


def test_terms_see_something(pair):
  """The shared state exercises the terms: a joint beyond its soft limit,
  a timed-out env, a foot on the floor, a non-zero command."""
  _, tctx = _ctxs(pair)
  assert float(tmdp.joint_pos_limits(
      tctx, ttc.SceneEntityCfg('robot').resolve(tctx.scene)).max()) > 0.05
  assert tmdp.time_out(tctx).tolist() == [False, True, False, False]
  assert float(tctx.commands['twist'].abs().min()) > 0
  assert float(tctx.actions.abs().max()) > 0
  assert float((tctx.actions - tctx.prev_actions).abs().max()) > 0


@pytest.mark.parametrize('mode', ['continuous', 'on_landing'])
@pytest.mark.parametrize('scale', ['smooth', 'hard'])
def test_feet_air_time_matches_jax(pair, mode, scale):
  rng = np.random.default_rng(1)
  state = {'current_air_time': np.abs(rng.normal(size=(N, 2))) * 0.1,
           'current_contact_time': np.abs(rng.normal(size=(N, 2))) * 0.1,
           'last_air_time': np.abs(rng.normal(size=(N, 2))) * 0.2}
  params = {'sensor_names': FOOT_SENSORS, 'command_name': 'twist',
            'reward_mode': mode, 'command_scale_type': scale,
            'threshold_min': 0.02}
  (jr, jst), (tr, tst) = _both(pair, 'feet_air_time', params, state)
  _close(tr, jr, 'reward')
  for k in jst:
    _close(tst[k], jst[k], k)
  init = tmdp.feet_air_time.init_state(num_envs=N, dtype=torch.float64,
                                       sensor_names=FOOT_SENSORS)
  assert init['last_air_time'].shape == (N, 2)


EVENTS = {
    'reset_scene_to_default': {},
    'reset_root_state_uniform': {
        'pose_range': {'x': (0.3, 0.3), 'y': (-0.2, -0.2), 'z': (0.05, 0.05),
                       'roll': (0.1, 0.1), 'pitch': (-0.2, -0.2),
                       'yaw': (0.7, 0.7)},
        'velocity_range': {'x': (0.1, 0.1), 'z': (-0.1, -0.1),
                           'pitch': (0.3, 0.3), 'yaw': (-0.4, -0.4)}},
    'reset_root_state_uniform/bare': ('reset_root_state_uniform', {
        'pose_range': {}, 'velocity_range': {}}),
    'reset_joints_by_scale': {'position_range': (0.9, 0.9),
                              'velocity_range': (0.5, 0.5)},
    'reset_joints_by_scale/clamped': ('reset_joints_by_scale', {
        'position_range': (9.0, 9.0), 'velocity_range': (0.0, 0.0)}),
    'push_by_setting_velocity': {
        'velocity_range': {'x': (0.3, 0.3), 'y': (-0.3, -0.3),
                           'yaw': (0.2, 0.2)}},
}


@pytest.mark.parametrize('masked', [True, False], ids=['masked', 'all'])
@pytest.mark.parametrize('case', list(EVENTS))
def test_data_event_matches_jax(pair, case, masked):
  jenv, tenv, js, ts = pair
  spec = EVENTS[case]
  name, params = spec if isinstance(spec, tuple) else (case, spec)
  jctx, tctx = _ctxs(pair)
  mask = MASK if masked else np.ones(N, bool)
  jf, tf = getattr(jmdp, name), getattr(tmdp, name)
  before = (ts.data.qpos.clone(), ts.data.qvel.clone())
  want = jf(jctx, js.data, jnp.asarray(mask), KEY,
            **_params(jtc, jman, jenv.scene, jf, params))
  got = tf(tctx, ts.data, torch.as_tensor(mask), _gen(),
           **_params(ttc, tman, tenv.scene, tf, params))
  _close(got.qpos, want.qpos, 'qpos')
  _close(got.qvel, want.qvel, 'qvel')
  assert torch.equal(ts.data.qpos, before[0]), 'qpos written in place'
  assert torch.equal(ts.data.qvel, before[1]), 'qvel written in place'
  assert not (torch.equal(got.qpos, before[0])
              and torch.equal(got.qvel, before[1]))
  if masked:
    assert torch.equal(got.qpos[1], before[0][1])
    assert torch.equal(got.qvel[3], before[1][3])


FOOT_GEOMS = _entity(geom_names=[r'^(left|right)_foot[1-7]_collision$'])


@pytest.mark.parametrize('operation', ['abs', 'add', 'scale'])
@pytest.mark.parametrize('ranges,axes', [
    ((0.55, 0.55), None), ({0: (0.8, 0.8), 2: (0.01, 0.01)}, [0, 1, 2])],
    ids=['tuple', 'per-axis'])
@pytest.mark.parametrize('distribution', ['uniform', 'log_uniform'])
def test_randomize_geom_friction_matches_jax(pair, operation, ranges, axes,
                                             distribution):
  jenv, tenv, js, ts = pair
  params = {'field': 'geom_friction', 'ranges': ranges, 'axes': axes,
            'operation': operation, 'distribution': distribution,
            'asset_cfg': FOOT_GEOMS}
  before = ts.model.geom_friction.clone()
  want = jmdp.randomize_field(
      js.model, jenv.scene, KEY, jnp.asarray(MASK),
      **_params(jtc, jman, jenv.scene, jmdp.randomize_field, params))
  got = tmdp.randomize_field(
      ts.model, tenv.scene, _gen(), torch.as_tensor(MASK),
      **_params(ttc, tman, tenv.scene, tmdp.randomize_field, params))
  _close(got.geom_friction, want.geom_friction, 'geom_friction', 1e-12)
  assert torch.equal(ts.model.geom_friction, before), 'written in place'
  assert torch.equal(got.geom_friction[1], before[1])
  assert not torch.equal(got.geom_friction[0], before[0])
  assert got.geom_friction.shape == (N, tenv.model.stat.ngeom, 3)


# the entities each kind of field is randomized on: some of them, so that
# the rows of the others must stay as they were
DR_ENTITIES = {
    'dof': SOME_JOINTS, 'joint': SOME_JOINTS, 'body': FEET,
    'geom': FOOT_GEOMS, 'site': _entity(site_names=['.*_foot', 'left_palm']),
}


@pytest.mark.parametrize('field', sorted(tmdp.FIELD_SPECS))
def test_randomize_field_matches_jax(pair, field):
  """Every field of FIELD_SPECS, env-expanded in both packages with the same
  distinct per-env values: `abs`, `scale` and `add` with a point range
  write the same values into the masked envs' rows of the selected
  entities, and leave every other row as it was."""
  jenv, tenv, js, ts = pair
  spec = tmdp.FIELD_SPECS[field]
  jm, tm = js.model, ts.model
  if field not in tenv.per_env_fields:
    jm = jexpand(jm, [field], N)
    tm = expand_model_fields(tm, [field], N)
  rng = np.random.default_rng(len(field))
  start = np.asarray(getattr(jm, field))
  start = start * rng.uniform(0.8, 1.2, start.shape) + rng.uniform(
      0.0, 0.1, start.shape)
  jm = jm.replace(**{field: jnp.asarray(start)})
  tm = tm.replace(**{field: torch.as_tensor(start)})
  params = {'field': field, 'asset_cfg': DR_ENTITIES[spec.entity_type]}
  ids = tevents._entity_indices(
      tenv.scene['robot'],
      _params(ttc, tman, tenv.scene, tmdp.randomize_field,
              params)['asset_cfg'], spec)
  picked = np.zeros(start.shape[1], bool)
  picked[ids] = True
  assert 0 < picked.sum() < len(picked)
  for operation, ranges in (('abs', (0.37, 0.37)), ('scale', (1.1, 1.1)),
                            ('add', (-0.05, -0.05))):
    case = {**params, 'operation': operation, 'ranges': ranges}
    want = jmdp.randomize_field(
        jm, jenv.scene, KEY, jnp.asarray(MASK),
        **_params(jtc, jman, jenv.scene, jmdp.randomize_field, case))
    got = tmdp.randomize_field(
        tm, tenv.scene, _gen(), torch.as_tensor(MASK),
        **_params(ttc, tman, tenv.scene, tmdp.randomize_field, case))
    new = getattr(got, field)
    _close(new, getattr(want, field), f'{field} {operation}', 1e-12)
    assert torch.equal(getattr(tm, field), torch.as_tensor(start)), \
        'written in place'
    changed = (new.numpy() != start).reshape(N, len(picked), -1).any(-1)
    assert not changed[~MASK].any(), f'{operation}: an unmasked env changed'
    assert not changed[:, ~picked].any(), \
        f'{operation}: an entity outside the selection changed'
    assert changed[MASK][:, picked].any(), f'{operation} wrote nothing'


def test_unknown_fields_are_refused(pair):
  """A field outside FIELD_SPECS is refused by name: the engine would read
  it as shared."""
  _, tenv, _, ts = pair
  with pytest.raises(NotImplementedError, match='geom_size'):
    expand_model_fields(tenv.scene.model, ['geom_size'], N)
  with pytest.raises(ValueError, match='unknown field'):
    tmdp.randomize_field(ts.model, tenv.scene, _gen(),
                         torch.as_tensor(MASK), field='geom_size',
                         ranges=(1.0, 1.0))


def test_randomize_field_needs_the_env_axis(pair):
  _, tenv, _, _ = pair
  with pytest.raises(ValueError, match='not env-expanded'):
    tmdp.randomize_field(
        tenv.scene.model, tenv.scene, _gen(), torch.as_tensor(MASK),
        field='geom_friction', ranges=(0.5, 0.5),
        asset_cfg=ttc.SceneEntityCfg('robot').resolve(tenv.scene))


def test_mix_params_with_env_axis(pair):
  """Per-env friction: (B, npair, 5), equal to the JAX vmap over the
  expanded leaf; with equal rows, bit-equal to the shared path, which
  itself is unchanged."""
  jenv, tenv, js, ts = pair
  rng = np.random.default_rng(2)
  fric = np.abs(rng.normal(size=(N, tenv.model.stat.ngeom, 3))) + 0.1
  tm = ts.model.replace(geom_friction=torch.as_tensor(fric))
  jm = js.model.replace(geom_friction=jnp.asarray(fric))
  base = tenv.scene.model
  for key, (g1s, g2s, pids, _, _) in base.stat.pairs.groups.items():
    want = jax.vmap(lambda f: jcol._mix_params(
        jm.replace(geom_friction=f), g1s, g2s, pids)[0])(jm.geom_friction)
    got = tcol._mix_params(tm, g1s, g2s, pids)
    assert got[0].shape == (N, len(g1s), 5), key
    _close(got[0], want, f'friction of {key}', 1e-12)
    shared = tcol._mix_params(base, g1s, g2s, pids)
    assert shared[0].shape == (len(g1s), 5)
    tiled = tcol._mix_params(expand_model_fields(base, ['geom_friction'], N),
                             g1s, g2s, pids)
    assert torch.equal(tiled[0], shared[0].expand(N, -1, -1)), key
    for a, b in zip(got[1:], shared[1:]):
      assert torch.equal(a, b)  # solref, solimp, margin stay shared


def test_collision_reads_per_env_friction(pair):
  _, tenv, _, ts = pair
  d = tcol.collision(ts.model, ts.data)
  base = tcol.collision(tenv.scene.model, ts.data)
  # point range 0.45 on the feet against the compiled 0.6
  assert not torch.equal(d.contact.friction, base.contact.friction)
  assert torch.equal(d.contact.dist, base.contact.dist)
  assert float(d.contact.friction.max()) <= 1.0


def test_mujoco_cfg_checks_the_compiled_options(pair):
  _, tenv, _, _ = pair
  mj = tenv.scene.mj_model
  tenv.cfg.sim.mujoco.check_model(mj)
  for wrong in (dict(timestep=0.002), dict(integrator='euler'),
                dict(iterations=5), dict(ls_iterations=50),
                dict(cone='elliptic'), dict(gravity=(0.0, 0.0, -1.62))):
    cfg = MujocoCfg(**{**dict(timestep=0.005, iterations=10,
                              ls_iterations=20), **wrong})
    with pytest.raises(ValueError, match=next(iter(wrong))):
      cfg.check_model(mj)


# ---------------------------------------------------------------------------
# managers on the shared state (point ranges: no value depends on a draw)
# ---------------------------------------------------------------------------


def _same_tree(got, want, path='', tol=TOL):
  assert set(got) == set(want), (path, set(got) ^ set(want))
  for k in want:
    if isinstance(want[k], dict):
      _same_tree(got[k], want[k], f'{path}/{k}', tol)
    else:
      _close(got[k], want[k], f'{path}/{k}', tol)


def test_action_manager_matches_jax(pair):
  jenv, tenv, js, ts = pair
  act = np.random.default_rng(3).normal(size=(N, 29))
  jp = jenv.action_manager.process(jnp.asarray(act))
  tp = tenv.action_manager.process(torch.as_tensor(act))
  _close(tp, jp, 'processed', 1e-12)
  jctx, tctx = _ctxs(pair)
  _close(tenv.action_manager.apply(tctx, ts.data, tp).ctrl,
         jenv.action_manager.apply(jctx, js.data, jp).ctrl, 'ctrl', 1e-12)
  assert tenv.action_dim == jenv.action_dim == 29


def test_observation_manager_matches_jax(pair):
  jenv, tenv, js, ts = pair
  jctx, tctx = _ctxs(pair)
  jobs, _ = jenv.observation_manager.compute(jctx, js.obs, KEY)
  tobs, _ = tenv.observation_manager.compute(tctx, ts.obs, _gen())
  _same_tree(tobs, jobs)
  assert tenv.observation_dims == jenv.observation_dims == {
      'policy': 99, 'critic': 99}
  # the policy group is corrupted (a constant offset here), the critic not
  assert not torch.equal(tobs['policy'], tobs['critic'])


def test_reward_manager_matches_jax(pair):
  jenv, tenv, js, ts = pair
  jctx, tctx = _ctxs(pair)
  jr = jenv.reward_manager.compute(jctx, js.reward_sums, jenv.step_dt,
                                   js.reward)
  tr = tenv.reward_manager.compute(tctx, ts.reward_sums, tenv.step_dt,
                                   ts.reward)
  _close(tr[0], jr[0], 'reward')
  _close(tr[1], jr[1], 'sums')
  _same_tree(tr[2], jr[2], 'values')
  names = tenv.reward_manager.active_terms
  assert names == jenv.reward_manager.active_terms
  # weight-0 terms are skipped, carry no state, and add nothing to the sums
  assert ts.reward == {} and tr[3] == {}
  col = names.index('flat_orientation_l2')
  assert torch.equal(tr[1][:, col], ts.reward_sums[:, col])
  assert float(tr[2]['air_time'].abs().max()) == 0.0


def test_termination_manager_matches_jax(pair):
  jenv, tenv, _, _ = pair
  jctx, tctx = _ctxs(pair)
  jt = jenv.termination_manager.compute(jctx)
  tt = tenv.termination_manager.compute(tctx)
  _close(tt[0], jt[0], 'terminated')
  _close(tt[1], jt[1], 'truncated')
  _same_tree(tt[2], jt[2], 'per term')
  assert tt[1].tolist() == [False, True, False, False]


@pytest.mark.parametrize('dt', [0.0, 0.02, 0.2])
def test_command_manager_matches_jax(pair, dt):
  """compute (metrics, clock, resample on expiry at dt = 0.2, heading
  servo) and a masked reset."""
  jenv, tenv, js, ts = pair
  jctx, tctx = _ctxs(pair)
  jc = jenv.command_manager.compute(js.command, jctx, KEY, dt)
  tc = tenv.command_manager.compute(ts.command, tctx, _gen(), dt)
  _same_tree(tc, jc, 'compute')
  jc, jm = jenv.command_manager.reset(js.command, jctx, jnp.asarray(MASK),
                                      KEY)
  tc, tm = tenv.command_manager.reset(ts.command, tctx,
                                      torch.as_tensor(MASK), _gen())
  _same_tree(tc, jc, 'reset')
  _same_tree(tm, jm, 'metrics')
  assert float(ts.command['twist']['metric/error_vel_xy'].min()) > 0
  assert tc['twist']['metric/error_vel_xy'][0] == 0


def test_event_manager_interval_matches_jax(pair):
  jenv, tenv, js, ts = pair
  jctx, tctx = _ctxs(pair)
  for left in (0.06, 0.02):  # keeps counting, then fires and resamples
    jev = {'push_robot/time_left': jnp.full(N, left)}
    tev = {'push_robot/time_left': torch.full((N,), left,
                                              dtype=torch.float64)}
    jd, jst = jenv.event_manager.apply_interval(jctx, js.data, jev, KEY)
    td, tst = tenv.event_manager.apply_interval(tctx, ts.data, tev, _gen())
    _same_tree(tst, jst, 'event state', 1e-15)
    _close(td.qvel, jd.qvel, 'qvel')
  assert not torch.equal(td.qvel, ts.data.qvel)
  assert tenv.per_env_fields == ['geom_friction'] == \
      jenv.event_manager.domain_randomization_fields()


@pytest.mark.parametrize('step', [0, 11999, 12000, 50000])
def test_commands_vel_curriculum_matches_jax(pair, step):
  jenv, tenv, js, ts = pair
  params = {'command_name': 'twist', 'base_range': (-1.0, 1.0),
            'velocity_stages': [{'step': 12000, 'range': (-3.0, 3.0)}]}
  jctx, tctx = _ctxs(pair)
  jctx.state = js.replace(common_step=jnp.asarray(step, jnp.int32))
  tctx.state = ts.replace(common_step=torch.tensor(step, dtype=torch.int32))
  jst, jmetric = jmdp.commands_vel(jctx, None, jnp.asarray(MASK), **params)
  tst, tmetric = tmdp.commands_vel(tctx, None, torch.as_tensor(MASK),
                                   **params)
  _same_tree(tst, jst)
  _close(tmetric, jmetric)
  init = tmdp.commands_vel.init_state(scene=tenv.scene, **params)
  _same_tree(init, jmdp.commands_vel.init_state(**params))
  # the command term draws inside the curriculum's range
  tctx.state = tctx.state.replace(curriculum={'command_vel': tst})
  term = tenv.command_manager.terms['twist']
  st = term._resample(ts.command['twist'], tctx,
                      torch.ones(N, dtype=torch.bool), _gen())
  assert float(st['command'][:, 0].abs().max()) <= float(tmetric)


WRENCH = {'force_range': (2.5, 2.5), 'torque_range': (-0.7, -0.7)}
WRENCH_BODIES = {
    'all': {},
    'torso': {'body_names': ['torso_link']},
    'feet': {'body_names': ['.*_ankle_roll_link']},
}


def _wrench_cfgs(pair, case):
  """(JAX SceneEntityCfg, port SceneEntityCfg) selecting the case's
  bodies. 'slice': the port's selects bodies 1-3 by a slice, the JAX one by
  their ids (the JAX term sizes a slice's draw by the entity's whole body
  count, so it takes no slice but the whole one)."""
  jenv, tenv, _, _ = pair
  names = WRENCH_BODIES.get(case, {})
  jcfg = jtc.SceneEntityCfg('robot', **names).resolve(jenv.scene)
  tcfg = ttc.SceneEntityCfg('robot', **names).resolve(tenv.scene)
  if case == 'slice':
    jcfg.body_ids = np.arange(1, 4, dtype=np.int32)
    tcfg.body_ids = slice(1, 4)
  return jcfg, tcfg


@pytest.mark.parametrize('masked', [True, False], ids=['masked', 'all'])
@pytest.mark.parametrize('case', [*WRENCH_BODIES, 'slice'])
def test_external_wrench_matches_jax(pair, case, masked):
  """apply_external_force_torque with its ranges collapsed to a point, over
  a wrench already on every body: the selected bodies of the masked envs
  take the drawn wrench, everything else keeps its own."""
  jenv, tenv, js, ts = pair
  jctx, tctx = _ctxs(pair)
  mask = MASK if masked else np.ones(N, bool)
  before = np.random.default_rng(5).normal(size=ts.data.xfrc_applied.shape)
  jd = js.data.replace(xfrc_applied=jnp.asarray(before))
  td = ts.data.replace(xfrc_applied=torch.as_tensor(before))
  jcfg, tcfg = _wrench_cfgs(pair, case)
  want = jmdp.apply_external_force_torque(
      jctx, jd, jnp.asarray(mask), KEY, asset_cfg=jcfg, **WRENCH)
  got = tmdp.apply_external_force_torque(
      tctx, td, torch.as_tensor(mask), _gen(), asset_cfg=tcfg, **WRENCH)
  _close(got.xfrc_applied, want.xfrc_applied, 'xfrc_applied')
  assert torch.equal(td.xfrc_applied, torch.as_tensor(before)), \
      'xfrc_applied written in place'
  view = tenv.scene['robot']
  ids = view.idx.body_ids[tcfg.body_ids]
  expect = {'all': len(view.idx.body_ids), 'torso': 1, 'feet': 2,
            'slice': 3}[case]
  assert len(ids) == expect
  hit = got.xfrc_applied[:, ids]
  on = torch.as_tensor(mask)
  assert torch.equal(hit[on], torch.tensor(
      [2.5, 2.5, 2.5, -0.7, -0.7, -0.7],
      dtype=torch.float64).expand_as(hit[on]))
  assert torch.equal(hit[~on], torch.as_tensor(before)[:, ids][~on])


def test_external_wrench_draws(pair):
  """The port's draws, 2000 envs x every body: force and torque inside
  their ranges, with the uniform's mean and variance, and no correlation
  between envs, between bodies, or between force and torque."""
  _, tenv, _, ts = pair
  n = 2000
  nbody = ts.data.xfrc_applied.shape[1]
  ctx = tenv._make_ctx(ts)
  ctx = type('Ctx', (), {'scene': ctx.scene, 'num_envs': n})()
  data = ts.data.replace(
      xfrc_applied=torch.zeros(n, nbody, 6, dtype=torch.float64),
      qpos=torch.zeros(n, ts.data.qpos.shape[1], dtype=torch.float64))
  cfg = ttc.SceneEntityCfg('robot').resolve(tenv.scene)
  lo, hi = (-20.0, 20.0), (-5.0, 5.0)
  got = tmdp.apply_external_force_torque(
      ctx, data, torch.ones(n, dtype=torch.bool), _gen(), force_range=lo,
      torque_range=hi, asset_cfg=cfg).xfrc_applied
  ids = tenv.scene['robot'].idx.body_ids
  frc, trq = got[:, ids, :3].numpy(), got[:, ids, 3:].numpy()
  for x, (a, b) in ((frc, lo), (trq, hi)):
    k = x.size
    assert a <= x.min() and x.max() < b
    mean, var = (a + b) / 2, (b - a) ** 2 / 12
    assert abs(x.mean() - mean) <= 4 * np.sqrt(var / k)
    # the sample variance of a uniform: its own variance is (b-a)^4/180
    assert abs(x.var() - var) <= 4 * np.sqrt((b - a) ** 4 / 180 / k)
    flat = (x - mean).reshape(n, -1)
    lim = 5 / np.sqrt(flat.size)
    env_corr = np.corrcoef(flat[:-1].ravel(), flat[1:].ravel())[0, 1]
    body_corr = np.corrcoef(flat[:, :-3].ravel(), flat[:, 3:].ravel())[0, 1]
    axis_corr = np.corrcoef(x[..., 0].ravel(), x[..., 1].ravel())[0, 1]
    assert max(abs(env_corr), abs(body_corr), abs(axis_corr)) < lim, (
        env_corr, body_corr, axis_corr)
  assert abs(np.corrcoef(frc.ravel(), trq.ravel())[0, 1]) < 5 / np.sqrt(
      frc.size)
  assert got[:, 0].abs().max() == 0  # the world body is not the robot's


def test_entity_reset_clears_the_wrench_of_reset_rows(pair):
  """The env's reset clears the wrench on the entity's bodies of the envs
  it resets, and only theirs, as the JAX entity's reset does."""
  jenv, tenv, js, ts = pair
  before = np.random.default_rng(6).normal(size=ts.data.xfrc_applied.shape)
  want = jenv.scene['robot'].reset(
      js.data.replace(xfrc_applied=jnp.asarray(before)), jnp.asarray(MASK))
  got = tenv.scene['robot'].reset(
      ts.data.replace(xfrc_applied=torch.as_tensor(before)),
      torch.as_tensor(MASK))
  _close(got.xfrc_applied, want.xfrc_applied, 'xfrc_applied')
  ids = tenv.scene['robot'].idx.body_ids
  assert got.xfrc_applied[torch.as_tensor(MASK)][:, ids].abs().max() == 0
  assert torch.equal(got.xfrc_applied[~torch.as_tensor(MASK)],
                     torch.as_tensor(before)[~MASK])
