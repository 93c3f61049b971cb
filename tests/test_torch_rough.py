"""The rough-terrain velocity tasks of the port against the JAX package.

The rough scenes built from the flat snapshots against MuJoCo's compile of
their spec; one physics step of each rough scene on stairs and noise in
float64 (≤ 1e-9, the hfield slots active); the terrain-level curriculum's
promotion and demotion (the draw for envs promoted past the top injected);
the G1 and Go1 rough envs with degenerate ranges over a reset and six
env-steps (≤ 1e-6); training of the rough task on the CPU with a resume;
and `list_envs`. Terrains are cut to a grid of 2 x 3 cells of 2 m with a
1 m border."""

from __future__ import annotations

import copy
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import g1_flat_arrays, go1_flat_arrays
from mjlab_torch.asset_zoo.rough_scene import (
    g1_rough_model,
    go1_rough_model,
    rough_scene_arrays,
)
from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.physics import io as tio
from mjlab_torch.physics.types import GeomType
from mjlab_torch.tasks.velocity.mdp import curriculums as tcurr
from mjlab_torch.terrains import generator as tgen
from mjlab_torch.terrains import sub_terrains as tsub
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import pipeline as jpipe
from mjlab_tpu.tasks.velocity.mdp import curriculums as jcurr
from chip_smoke import go1_floor_states
from tests.torch_parity import (
    env_state_leaves,
    jax_batch,
    jax_env_f64,
    to_port,
)

G1_TASK = 'Mjlab-Velocity-Rough-Unitree-G1'
GO1_TASK = 'Mjlab-Velocity-Rough-Unitree-Go1'
TASKS = {'g1': G1_TASK, 'go1': GO1_TASK}
SCENES = {'g1': (g1_flat_arrays, g1_rough_model),
          'go1': (go1_flat_arrays, go1_rough_model)}
# the small grid of the CPU tests: 2 x 3 cells of 2 m, a 1 m border
SMALL = dict(size=(2.0, 2.0), border_width=1.0, num_rows=2, num_cols=3)

# a row of pyramid stairs (0.1 m steps on 0.3 m treads) and uniform noise
# at full difficulty, for the physics step
STEP_TERRAIN = tgen.TerrainGeneratorCfg(
    size=(2.0, 2.0), border_width=1.0, num_rows=1, num_cols=2,
    difficulty_range=(1.0, 1.0), sub_terrains={
        'stairs': tsub.BoxPyramidStairsTerrainCfg(
            proportion=0.5, step_height_range=(0.1, 0.1), step_width=0.3,
            platform_width=0.6, border_width=0.1),
        'noise': tsub.HfRandomUniformTerrainCfg(
            proportion=0.5, noise_range=(0.02, 0.06), noise_step=0.02)})


@pytest.mark.parametrize('robot', sorted(SCENES))
def test_rough_scene_matches_its_spec_compile(robot):
  """A flat snapshot with the generator's heightfield put in is the scene
  MuJoCo compiles from the spec: every snapshot field equal, the spec
  inputs it records those of the rough cfg on that terrain, but the name
  buffer, into which the compile inserts the heightfield's own name ahead
  of the actuators' and sensors' (every name the engine reads, compared by
  kind, is equal); the engine's Models equal."""
  from mjlab_torch.scene.scene import recording, spec_inputs
  from mjlab_torch.tasks import registry as treg
  flat, compile_spec = SCENES[robot]
  gen = tgen.TerrainGenerator(copy.deepcopy(STEP_TERRAIN))
  got = rough_scene_arrays(flat(), gen)
  mj = compile_spec(gen)
  cfg = treg.load_cfg(TASKS[robot]).scene
  cfg.terrain.terrain_generator = gen.cfg
  want = recording(tio.ModelArrays.of(mj), spec_inputs(cfg))
  a, b = got.arrays(), want.arrays()
  assert sorted(a) == sorted(b)
  names = ('names', 'name_actuatoradr', 'name_sensoradr')
  for k in sorted(set(a) - set(names)):
    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  for kind, n in (('body', mj.nbody), ('jnt', mj.njnt), ('geom', mj.ngeom),
                  ('site', mj.nsite), ('actuator', mj.nu),
                  ('sensor', mj.nsensor)):
    assert tio.names_of(got, kind, n) == tio.names_of(want, kind, n), kind
  tm = tphys.put_model(got, device='cpu', dtype=torch.float64)
  wm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  assert tm.stat == wm.stat
  for f in tio.MODEL_FIELDS:
    assert torch.equal(getattr(tm, f), getattr(wm, f)), f
  assert tm.stat.hfield_geomid == 0
  assert tm.stat.sensor_refid.tolist() == [0] * mj.nsensor  # 'terrain'


@functools.lru_cache(maxsize=None)
def _step_case(robot):
  """The rough scene on STEP_TERRAIN and eight states of the robot set
  onto stairs and noise: G1s standing 2 cm into the surface below their
  root, two of them lying on it (the pelvis and head spheres touch); Go1s
  as go1_floor_states puts them on the floor (a third on their backs, the
  trunk box flat), lifted by the surface's height there."""
  gen = tgen.TerrainGenerator(copy.deepcopy(STEP_TERRAIN))
  mj = SCENES[robot][1](gen)
  n = 8
  rng = np.random.default_rng(3)
  origins = gen.origins.reshape(-1, 3)
  xy = origins[np.arange(n) % len(origins), :2] + rng.uniform(
      -0.7, 0.7, size=(n, 2))
  ground = gen.sample_height(xy[:, 0], xy[:, 1])
  if robot == 'g1':
    qpos = np.tile(mj.key_qpos[0], (n, 1))
    qpos[:, 7:] += 0.05 * rng.normal(size=(n, mj.nq - 7))
    qvel = 0.3 * rng.normal(size=(n, mj.nv))
    qpos[:, 2] += ground - 0.02
    qpos[:2, 2] = ground[:2] + 0.06
    qpos[:2, 3:7] = [np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0]
  else:
    qpos, qvel = go1_floor_states(mj.key_qpos[0], mj.nv, n, seed=3)
    qpos[:, 2] += ground
  qpos[:, :2] = xy
  ctrl = np.tile(mj.key_ctrl[0], (n, 1))
  return mj, qpos, qvel, ctrl


@pytest.mark.parametrize('robot', sorted(SCENES))
def test_step_on_rough_scene_matches_jax(robot):
  """One physics step of each rough scene (robot geoms against the
  heightfield, the G1's self-collision too) in float64 against the JAX
  package, ≤ 1e-9; the hfield slots are active."""
  mj, qpos, qvel, ctrl = _step_case(robot)
  jm = jio.put_model(mj, dtype=jnp.float64)
  jd = jax_batch(jm, len(qpos), qpos, qvel, ctrl)
  tm, td = to_port(jm, jd, mj)
  want = jax.jit(jax.vmap(jpipe.step, in_axes=(None, 0)))(jm, jd)
  got = tphys.step(tm, td)
  for f in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata',
            'ncon_active'):
    np.testing.assert_allclose(getattr(got, f).numpy(),
                               np.asarray(getattr(want, f)), rtol=0,
                               atol=1e-9, err_msg=f)
  c = got.contact
  active = (c.dist < c.includemargin)
  for key, (_, _, _, base, npts) in tm.stat.pairs.groups.items():
    if key[0] == int(GeomType.HFIELD):
      n = len(tm.stat.pairs.groups[key][0])
      assert active[:, base:base + n * npts].any(), GeomType(key[1]).name
  assert (got.sensordata > 0).any()  # a foot sensor found the heightfield


def _small(cfg, num_envs, tilt=True):
  """A rough cfg on the small grid, its sampling ranges collapsed to a
  point. With `tilt` the reset pose is tilted a little: on a flat tread the
  feet's sample spheres of a level robot lie at one depth, and which of
  several exactly tied slots the contact compaction keeps (its cap is 32 of
  the G1's 90-odd frictional slots) then hangs on last-bit differences of
  the two engines' kinematics, which permute the efc rows and their forces
  while the dynamics agree (test_level_pose_keeps_the_dynamics)."""
  from chip_smoke import degenerate_ranges
  gen = cfg.scene.terrain.terrain_generator
  for k, v in SMALL.items():
    setattr(gen, k, v)
  cfg = degenerate_ranges(cfg, num_envs)
  if not tilt:
    return cfg
  base = cfg.events.reset_base
  base.params = {**base.params, 'pose_range': {
      **base.params['pose_range'], 'roll': (0.03, 0.03),
      'pitch': (-0.04, -0.04)}}
  return cfg


@functools.lru_cache(maxsize=None)
def _pair(robot, num_envs=2, tilt=True):
  """(JAX env, port env) of a rough task on the small grid, both float64
  on one compiled model, every range a point."""
  from mjlab_torch.tasks import registry as treg
  from mjlab_tpu.tasks import registry as jreg
  task = TASKS[robot]
  jenv = jax_env_f64(_small(jreg.load_cfg(task), num_envs, tilt))
  tenv = treg.make(task, cfg=_small(treg.load_cfg(task), num_envs, tilt),
                   device='cpu', dtype=torch.float64,
                   mj_model=jenv.scene.mj_model)
  return jenv, tenv


def test_port_scene_of_the_rough_env_is_the_jax_envs():
  """Built from its own snapshot and generator, the port's G1 rough env on
  the small grid holds the JAX env's heightfield, terrain geom and pair
  table widths."""
  from mjlab_torch.tasks import registry as treg
  jenv, _ = _pair('g1')
  tenv = treg.make(G1_TASK, cfg=_small(treg.load_cfg(G1_TASK), 2),
                   device='cpu', dtype=torch.float64)
  jm, tm = jenv.scene.model, tenv.scene.model
  np.testing.assert_array_equal(tm.hfield_data.numpy(),
                                np.asarray(jm.hfield_data))
  for f in ('nhfield', 'hfield_nrow', 'hfield_ncol'):
    assert getattr(tm.stat, f) == getattr(jm.stat, f), f
  np.testing.assert_array_equal(tm.stat.hfield_size, jm.stat.hfield_size)
  g_t, g_j = tm.stat.hfield_geomid, jm.stat.hfield_geomid
  for f in ('geom_pos', 'geom_size', 'geom_friction', 'geom_solref',
            'geom_solimp', 'geom_margin'):
    np.testing.assert_array_equal(getattr(tm, f)[g_t].numpy(),
                                  np.asarray(getattr(jm, f))[g_j], err_msg=f)
  assert tm.stat.pairs.ncon_max == jm.stat.pairs.ncon_max
  assert (tm.stat.ncon_cap, tm.stat.ncon_cap1) == (jm.stat.ncon_cap,
                                                   jm.stat.ncon_cap1)
  np.testing.assert_array_equal(tenv.scene.terrain.origins_table,
                                jenv.scene.terrain.origins_table)


def _jax_draw(step, n, max_level):
  key = jax.random.fold_in(jax.random.PRNGKey(17), step)
  return np.asarray(jax.random.randint(key, (n,), 0, max_level))


def test_terrain_levels_vel_matches_jax(monkeypatch):
  """Promotion past half a cell, demotion under half the commanded
  distance, the floor at level 0, an env promoted past the top sent to the
  drawn level (JAX's draw injected into the port), masked-out envs kept:
  levels, origins and the metric against the JAX term."""
  jenv, tenv = _pair('g1', 6)
  n, max_level = 6, tenv.scene.terrain.max_level
  assert max_level == 2
  levels = np.array([0, 1, 1, 0, 1, 0], np.int32)
  walked = np.array([1.5, 0.2, 3.0, 0.2, 0.8, 1.2])  # m from the origin
  mask = np.array([True, True, True, True, True, False])
  cmd = np.tile([0.6, 0.2, 0.3, 0.5], (n, 1))
  cmd[4, :2] = 0.0  # standing: no distance required
  types = tenv.scene.terrain.terrain_types
  table = tenv.scene.terrain.origins_table
  origins = table[levels, types]
  root = origins + np.stack([walked, np.zeros(n), np.full(n, 0.7)], -1)
  step = 37
  draw = _jax_draw(step, n, max_level)

  jctx = jenv._make_ctx(jenv._template_state)
  rid = jenv.scene['robot'].idx.root_body_id
  jxpos = np.asarray(jctx.data.xpos).copy()
  jxpos[:, rid] = root
  jstate = jenv._template_state.replace(common_step=jnp.asarray(step))
  jctx = dataclasses.replace(
      jctx, data=jctx.data.replace(xpos=jnp.asarray(jxpos)),
      commands={'twist': jnp.asarray(cmd)}, state=jstate)
  params = {'command_name': 'twist',
            'asset_cfg': tenv.curriculum_manager.params['terrain_levels'][
                'asset_cfg']}
  jparams = dict(jenv.curriculum_manager.params['terrain_levels'])
  want, wmetric = jcurr.terrain_levels_vel(
      jctx, {'levels': jnp.asarray(levels), 'origins': jnp.asarray(origins)},
      jnp.asarray(mask), **jparams)

  tctx = tenv._make_ctx(tenv._template_state)
  txpos = tctx.data.xpos.clone()
  txpos[:, rid] = torch.as_tensor(root)
  tctx = dataclasses.replace(
      tctx, data=tctx.data.replace(xpos=txpos),
      commands={'twist': torch.as_tensor(cmd)})
  monkeypatch.setattr(tcurr, 'draw_levels',
                      lambda ctx, num, top: torch.as_tensor(draw))
  got, metric = tcurr.terrain_levels_vel(
      tctx, {'levels': torch.as_tensor(levels),
             'origins': torch.as_tensor(origins)},
      torch.as_tensor(mask), **params)
  np.testing.assert_array_equal(got['levels'].numpy(),
                                np.asarray(want['levels']))
  np.testing.assert_array_equal(got['origins'].numpy(),
                                np.asarray(want['origins']))
  assert float(metric) == float(wmetric)
  # up, down, up past the top (the draw), floor, stay, masked out
  expect = [1, 0, draw[2], 0, 1, 0]
  assert got['levels'].tolist() == expect


def _close(got, want, what, tol=1e-6):
  got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0, atol=tol,
                               err_msg=what)


def _same_tree(got, want, path):
  for k, v in got.items():
    if isinstance(v, dict):
      _same_tree(v, want[k], f'{path}/{k}')
    else:
      _close(v, want[k], f'{path}/{k}')


@pytest.mark.parametrize('robot', sorted(TASKS))
def test_six_env_steps_match_jax(robot):
  """Reset and six env-steps of the rough task against the JAX env, both
  float64 on one compiled model, every range a point: observations,
  rewards, done flags, extras (the terrain-level metric included) and every
  leaf of the state within 1e-6, with env 0 (on level 1) tipped over
  before the third step: a masked reset that demotes it, moves its spawn
  origin and spawns it there."""
  jenv, tenv = _pair(robot)
  obs_dim = {'g1': 99, 'go1': 48}[robot]
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  for g in ('policy', 'critic'):
    _close(tobs[g], jobs[g], f'reset obs {g}', 1e-9)
    assert tobs[g].shape == (2, obs_dim)
  _same_tree(env_state_to_numpy(tenv.state, tenv),
             env_state_leaves(jenv.state), 'reset state')
  assert tenv.state.curriculum['terrain_levels']['levels'].tolist() == [1, 0]
  origins0 = tenv.state.curriculum['terrain_levels']['origins'].clone()
  rng = np.random.default_rng(0)
  fired = []
  for i in range(6):
    act = 0.3 * rng.normal(size=(2, tenv.action_dim))
    if i == 2:
      qpos = np.asarray(jenv.state.data.qpos).copy()
      half = np.radians(80.0) / 2
      qpos[0, 3:7] = [np.cos(half), np.sin(half), 0.0, 0.0]
      js, ts = jenv.state, tenv.state
      jenv._state = js.replace(data=js.data.replace(qpos=jnp.asarray(qpos)))
      tenv._state = ts.replace(
          data=ts.data.replace(qpos=torch.as_tensor(qpos)))
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(torch.as_tensor(act))
    what = f'step {i}'
    for g in ('policy', 'critic'):
      _close(tout[0][g], jout[0][g], f'{what} obs {g}')
    for k, name in ((1, 'reward'), (2, 'terminated'), (3, 'truncated')):
      _close(tout[k], jout[k], f'{what} {name}')
    assert set(tout[4]) == set(jout[4]), what
    assert 'Curriculum/terrain_levels' in tout[4]
    _same_tree(tout[4], jout[4], f'{what} extras')
    _same_tree(env_state_to_numpy(tenv.state, tenv),
               env_state_leaves(jenv.state), f'{what} state')
    fired.append(tout[2].tolist())
  assert fired == [[i == 2, False] for i in range(6)]
  levels = tenv.state.curriculum['terrain_levels']['levels']
  assert levels.tolist() == [0, 0]  # env 0 demoted from level 1
  origins = tenv.state.curriculum['terrain_levels']['origins']
  assert not torch.equal(origins[0], origins0[0])
  assert torch.equal(origins[1], origins0[1])
  # env 0 respawned at its new origin
  root = tenv.scene['robot'].root_pos_w(tenv.state.data)[0]
  assert float((root[:2] - origins[0, :2]).abs().max()) < 1.0


@pytest.mark.parametrize('robot', sorted(TASKS))
def test_level_pose_keeps_the_dynamics(robot):
  """The reset pose untilted: a level robot's foot sample spheres tie
  exactly on a flat tread, and the compaction may keep other tied slots
  than the JAX env's (on the G1 the reset's efc rows come out permuted).
  The motion does not hang on which: qpos, qvel, qacc and the observations
  over a reset and six env-steps within 1e-6 of the JAX env, and each
  env's efc forces equal as a set."""
  jenv, tenv = _pair(robot, tilt=False)
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  rng = np.random.default_rng(0)
  for i in range(7):
    what = f'step {i - 1}' if i else 'reset'
    for g in ('policy', 'critic'):
      _close(tobs[g], jobs[g], f'{what} obs {g}')
    for f in ('qpos', 'qvel', 'qacc'):
      _close(getattr(tenv.state.data, f), getattr(jenv.state.data, f),
             f'{what} {f}')
    _close(tenv.state.data.efc_force.sort(-1).values,
           np.sort(np.asarray(jenv.state.data.efc_force), -1),
           f'{what} efc_force as a set')
    if i < 6:
      act = 0.3 * rng.normal(size=(2, tenv.action_dim))
      jobs = jenv.step(jnp.asarray(act))[0]
      tobs = tenv.step(torch.as_tensor(act))[0]


def test_list_envs_lists_the_rough_tasks(capsys):
  from mjlab_torch.scripts import list_envs
  tasks = list_envs.main([])
  rough = {t + p for t in TASKS.values() for p in ('', '-Play')}
  assert rough <= set(tasks)
  out = capsys.readouterr().out
  assert all(t in out for t in rough)


SMALL_ARGS = ['--env.scene.terrain.terrain_generator.num_rows', '2',
              '--env.scene.terrain.terrain_generator.num_cols', '3',
              '--env.scene.terrain.terrain_generator.size', '(2.0, 2.0)',
              '--env.scene.terrain.terrain_generator.border_width', '1.0',
              '--agent.num_steps_per_env', '2',
              '--agent.policy.actor_hidden_dims', '(16, 16)',
              '--agent.policy.critic_hidden_dims', '(16,)']


def test_train_resume_and_play_rough_on_cpu(tmp_path):
  """`scripts.train` of the G1 rough task for one iteration on the CPU
  logs the terrain-level metric and exports the ONNX; a resume numbers on
  from the checkpoint; `scripts.play` of the Play cfg runs it."""
  from mjlab_torch.scripts import play, train
  argv = [G1_TASK, '--device', 'cpu', '--log-root', str(tmp_path),
          '--env.scene.num_envs', '2', '--agent.max_iterations', '1',
          '--agent.save_interval', '1'] + SMALL_ARGS
  train.main(argv + ['--run-name', 'first'])
  run = tmp_path / 'g1_rough' / 'first'
  with open(run / 'metrics.jsonl') as f:
    logs = [json.loads(line) for line in f]
  assert 'Curriculum/terrain_levels' in logs[-1]
  assert 0.0 <= logs[-1]['Curriculum/terrain_levels'] <= 1.0
  assert (run / 'model_1.pt').exists() and (run / 'model_1.onnx').exists()
  train.main(argv + ['--run-name', 'second', '--resume'])
  assert (tmp_path / 'g1_rough' / 'second' / 'model_2.pt').exists()
  stats = play.main([G1_TASK + '-Play', '--device', 'cpu', '--num-envs',
                     '2', '--steps', '3', '--log-root',
                     str(tmp_path)] + SMALL_ARGS[:8] + SMALL_ARGS[10:])
  assert np.isfinite(stats['mean_reward'])
