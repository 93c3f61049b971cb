"""The TinyBot debug tasks of the port against the JAX package.

`Mjlab-Velocity-Flat-Tiny`, `Mjlab-Velocity-Rough-Tiny` and
`Mjlab-Tracking-Flat-Tiny`: the committed TinyBot snapshot (and the rough
scene built from it) against the JAX package's compile; the registry with
and without `MJLAB_TASKS_MODULES`; a reset and six env-steps of each task
against the JAX env in float64 with every sampling range a point
(≤ 1e-6), tracking on one clip written by both packages'
`write_tiny_motion` (≤ 1e-5 apart) and converted by `scripts.motion
--robot tiny`; and `scripts.train` then `scripts.play` of the flat task
on the CPU in subprocesses. The rough
terrain is cut to a grid of 2 x 3 cells of 2 m with a 1 m border."""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
import mjlab_torch.tasks.tracking.config.tiny as ttrack  # registers
import mjlab_torch.tasks.velocity.config.tiny  # noqa: F401 (registers)
import mjlab_tpu.tasks.tracking.config.tiny as jtrack  # registers
import mjlab_tpu.tasks.velocity.config.tiny  # noqa: F401 (registers)
from chip_smoke import degenerate_ranges, tracking_degenerate_ranges
from mjlab_torch.asset_zoo import tiny_flat_arrays
from mjlab_torch.asset_zoo.rough_scene import rough_scene_arrays
from mjlab_torch.asset_zoo.tiny_scene import tiny_flat_model
from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.physics import io as tio
from mjlab_torch.terrains import generator as tgen
from torch_parity import env_state_leaves, jax_env_f64

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAT = 'Mjlab-Velocity-Flat-Tiny'
ROUGH = 'Mjlab-Velocity-Rough-Tiny'
TRACK = 'Mjlab-Tracking-Flat-Tiny'
MODULES = ('mjlab_torch.tasks.velocity.config.tiny,'
           'mjlab_torch.tasks.tracking.config.tiny')
# the small grid of the CPU tests: 2 x 3 cells of 2 m, a 1 m border
SMALL = dict(size=(2.0, 2.0), border_width=1.0, num_rows=2, num_cols=3)
N = 3
TOL = 1e-6


def _jax_compile(cfg):
  """The MjModel the JAX env compiles for `cfg`."""
  from mjlab_tpu.scene.scene import Scene
  scene = Scene(cfg.scene)
  cfg.sim.mujoco.edit_spec(scene.spec)
  return scene.compile()


def _small_grid(cfg):
  if cfg.scene.terrain.terrain_generator is not None:
    gen = cfg.scene.terrain.terrain_generator
    for k, v in SMALL.items():
      setattr(gen, k, v)
  return cfg


def _same_snapshot(got: tio.ModelArrays, want: tio.ModelArrays, mj):
  """Every snapshot field equal but the name buffer, into which the JAX
  scene's compile puts names of its own (its skybox texture, a
  heightfield's); every name the engine reads, compared by kind, equal."""
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


def test_snapshot_is_the_scene_builders_compile():
  fresh = tio.ModelArrays.of(tiny_flat_model()).arrays()
  saved = tiny_flat_arrays().arrays()
  assert sorted(fresh) == sorted(saved)
  for k in fresh:
    np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def test_flat_snapshot_is_the_jax_compile_of_both_flat_tasks():
  """The velocity and the tracking Tiny cfgs compile one scene, and the
  committed snapshot is it."""
  from mjlab_tpu.tasks import registry as jreg
  snap = tiny_flat_arrays()
  for task in (FLAT, TRACK):
    mj = _jax_compile(jreg.load_cfg(task))
    _same_snapshot(snap, tio.ModelArrays.of(mj), mj)
  assert (mj.nq, mj.nv, mj.nu, mj.nbody, mj.ngeom) == (9, 8, 2, 4, 8)


def test_rough_scene_is_the_jax_compile():
  """The flat snapshot with the port's generator's heightfield put in is
  the JAX rough Tiny env's compile; the engine's Models equal."""
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.tasks import registry as treg
  mj = _jax_compile(_small_grid(jreg.load_cfg(ROUGH)))
  gen_cfg = _small_grid(treg.load_cfg(ROUGH)).scene.terrain.terrain_generator
  got = rough_scene_arrays(tiny_flat_arrays(),
                           tgen.TerrainGenerator(copy.deepcopy(gen_cfg)))
  _same_snapshot(got, tio.ModelArrays.of(mj), mj)
  tm = tphys.put_model(got, device='cpu', dtype=torch.float64)
  wm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  assert tm.stat == wm.stat
  for f in tio.MODEL_FIELDS:
    assert torch.equal(getattr(tm, f), getattr(wm, f)), f


def test_registry_lists_the_jax_packages_tasks():
  """Without MJLAB_TASKS_MODULES both registries list the 12 tasks of the
  robots; naming the Tiny modules adds the same three to both."""
  code = f"""
import os
from mjlab_torch.tasks import registry as t
from mjlab_tpu.tasks import registry as j
a, b = t.registered_tasks(), j.registered_tasks()
assert a == b and len(a) == 12 and not any('Tiny' in x for x in a), (a, b)
os.environ['MJLAB_TASKS_MODULES'] = {MODULES!r}
t_ids = t.registered_tasks()
os.environ['MJLAB_TASKS_MODULES'] = {MODULES.replace('torch', 'tpu')!r}
j_ids = j.registered_tasks()
assert t_ids == j_ids and len(t_ids) == 15, (t_ids, j_ids)
assert sorted(set(t_ids) - set(a)) == [{TRACK!r}, {FLAT!r}, {ROUGH!r}]
print('ok')
"""
  env = {k: v for k, v in os.environ.items() if k != 'MJLAB_TASKS_MODULES'}
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr[-2000:]
  assert out.stdout.strip().endswith('ok')


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
  """The port's Tiny clip, held to the JAX package's of the same recipe."""
  root = tmp_path_factory.mktemp('tiny_clip')
  port = ttrack.write_tiny_motion(str(root / 'port.npz'), device='cpu')
  jax_clip = jtrack.write_tiny_motion(str(root / 'jax.npz'),
                                      tmp_csv=str(root / 'jax.csv'))
  assert os.path.exists(root / 'port.csv')
  with np.load(port) as p, np.load(jax_clip) as j:
    assert sorted(p.files) == sorted(j.files)
    for k in j.files:
      assert p[k].shape == j[k].shape and p[k].shape[0] == 99, k
      np.testing.assert_allclose(p[k], j[k], rtol=0, atol=1e-5, err_msg=k)
  return port


def test_motion_cli_converts_a_tinybot_csv(clip, tmp_path):
  """`scripts.motion --robot tiny` runs write_tiny_motion's CSV through
  the same pipeline on the TinyBot scene: the same clip."""
  from mjlab_torch.scripts import motion
  out = str(tmp_path / 'cli.npz')
  motion.main(['--robot', 'tiny', '--csv', clip.replace('.npz', '.csv'),
               '--output', out, '--device', 'cpu'])
  with np.load(out) as a, np.load(clip) as b:
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
      np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _tilted(cfg):
  """The reset pose tilted a little: a level base box on the plane or a
  flat tread meets it with four corners at one depth, and which of those
  tied candidates the box collider keeps in which slot then hangs on
  last-bit differences of the two engines (as in test_torch_rough)."""
  base = cfg.events.reset_base
  base.params = {**base.params, 'pose_range': {
      **base.params['pose_range'], 'roll': (0.03, 0.03),
      'pitch': (-0.04, -0.04)}}
  return cfg


def _edit(task, clip):
  if task == TRACK:
    return lambda cfg: tracking_degenerate_ranges(cfg, N, clip)
  return lambda cfg: _tilted(degenerate_ranges(_small_grid(cfg), N))


@functools.lru_cache(maxsize=None)
def _pair(task, clip=None, cone='pyramidal'):
  """(JAX env, port env) of a Tiny task, both float64 on one compiled
  model, every sampling range a point."""
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.tasks import registry as treg
  edit = _edit(task, clip)
  jcfg, tcfg = edit(jreg.load_cfg(task)), edit(treg.load_cfg(task))
  # replaced, not edited: the JAX cfgs share one module-level sim cfg
  for cfg in (jcfg, tcfg):
    cfg.sim = dataclasses.replace(cfg.sim, mujoco=dataclasses.replace(
        cfg.sim.mujoco, cone=cone))
  jenv = jax_env_f64(jcfg, quick=True)
  tenv = treg.make(task, cfg=tcfg, device='cpu', dtype=torch.float64,
                   mj_model=jenv.scene.mj_model)
  return jenv, tenv


def _close(got, want, what, tol=TOL):
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
  assert set(got) <= set(want), path
  for k, v in got.items():
    if isinstance(v, dict):
      _same_tree(v, want[k], f'{path}/{k}')
    else:
      _close(v, want[k], f'{path}/{k}')


def six_env_steps(jenv, tenv):
  """A reset and six env-steps of both envs under one seeded action
  sequence, env 1 tipped onto its side before the third: observations,
  rewards, done flags, extras and every state leaf within 1e-6. Returns
  the port's done flags of each step."""
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  for g in jobs:
    _close(tobs[g], jobs[g], f'reset obs {g}', 1e-9)
  leaves = lambda: (env_state_to_numpy(tenv.state, tenv),
                    env_state_leaves(jenv.state, tenv.per_env_fields))
  _same_tree(*leaves(), 'reset state')
  rng = np.random.default_rng(0)
  fired, touched = [], torch.zeros(N, dtype=torch.bool)
  for i in range(6):
    act = 0.3 * rng.normal(size=(N, tenv.action_dim))
    if i == 2:
      qpos = np.asarray(jenv.state.data.qpos).copy()
      half = np.radians(100.0) / 2
      qpos[1, 3:7] = [np.cos(half), np.sin(half), 0.0, 0.0]
      js, ts = jenv.state, tenv.state
      jenv._state = js.replace(data=js.data.replace(qpos=jnp.asarray(qpos)))
      tenv._state = ts.replace(
          data=ts.data.replace(qpos=torch.as_tensor(qpos)))
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(torch.as_tensor(act))
    what = f'step {i}'
    for g in jout[0]:
      _close(tout[0][g], jout[0][g], f'{what} obs {g}')
    for k, name in ((1, 'reward'), (2, 'terminated'), (3, 'truncated')):
      _close(tout[k], jout[k], f'{what} {name}')
    assert set(tout[4]) == set(jout[4]), what
    _same_tree(tout[4], jout[4], f'{what} extras')
    _same_tree(*leaves(), f'{what} state')
    fired.append(tout[2].tolist())
    touched |= tenv.state.data.ncon_active > 0
  assert bool(touched.any())  # contacts made rows
  return fired


@pytest.mark.parametrize('task', [FLAT, ROUGH, TRACK])
def test_six_env_steps_match_jax(task, clip):
  jenv, tenv = _pair(task, clip if task == TRACK else None)
  assert tenv.model.stat.cone == 0
  assert 'geom_friction' in tenv.per_env_fields
  fired = six_env_steps(jenv, tenv)
  # env 1, on its side, ends by fell_over (velocity) or anchor_ori
  assert fired[2] == [False, True, False], fired
  if task == ROUGH:
    assert tenv.model.stat.nhfield == 1
    assert 'Curriculum/terrain_levels' in tenv.last_extras


def _run(mod, *args):
  env = {**os.environ, 'MJLAB_TASKS_MODULES': MODULES}
  out = subprocess.run([sys.executable, '-m', mod, *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=600, env=env)
  assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-1500:])
  return out.stdout


def test_train_then_play_flat_tiny_on_cpu(tmp_path):
  """`scripts.train` of Flat-Tiny for two iterations at 8 envs on the CPU
  writes the checkpoint and its ONNX; `scripts.play` finds it under the
  log root and replays it."""
  log_root = str(tmp_path / 'logs')
  _run('mjlab_torch.scripts.train', FLAT, '--device', 'cpu',
       '--log-root', log_root, '--run-name', 'smoke',
       '--env.scene.num_envs', '8', '--agent.max_iterations', '2',
       '--agent.num_steps_per_env', '4', '--agent.save_interval', '2')
  run = tmp_path / 'logs' / 'tiny_velocity' / 'smoke'
  assert (run / 'model_2.pt').exists() and (run / 'model_2.onnx').exists()
  out = _run('mjlab_torch.scripts.play', FLAT, '--device', 'cpu',
             '--agent', 'trained', '--steps', '3', '--num-envs', '4',
             '--log-root', log_root)
  assert f'loading {run / "model_2.pt"}' in out
