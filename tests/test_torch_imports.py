"""The port stands alone: no module of mjlab_torch, and not chip_smoke.py,
imports JAX, flax, optax, orbax or the JAX package, and the viewer stack
and the memory guard import without mujoco; the G1 and Go1 flat
environments and the G1 tracking environment are made and stepped, and the
engine's oracle models of equality constraints, tendons, sensors and the
convex and mesh colliders stepped (the mesh hulls built from a snapshot),
without the mujoco package; its entry
points default to the GPU and refuse to fall back to the CPU silently; its
kernel wrappers refuse CPU tensors."""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mjlab_torch
import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import g1_flat_arrays
from mjlab_torch.ops import _build
from mjlab_torch.ops import newton as tnewton
from mjlab_torch.ops import pd_solve as tpd
from mjlab_torch.ops import smooth_kernel as tsk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mjlab_tpu')
SUBPACKAGES = ('utils', 'sim', 'entity', 'scene', 'terrains', 'managers',
               'envs', 'tasks', 'rl', 'scripts', 'physics', 'ops', 'asset_zoo',
               'parallel', 'viewer')


def one_thread(**extra) -> dict:
  """The environment of a subprocess: its tiny ops run fastest, and slow
  the other test workers least, on one intra-op thread
  (tests/torch_parity.py)."""
  return {**os.environ, 'OMP_NUM_THREADS': '1', **extra}


def _modules():
  return sorted(m.name for m in pkgutil.walk_packages(
      mjlab_torch.__path__, prefix='mjlab_torch.'))


def test_the_walk_reaches_every_subpackage():
  mods = _modules()
  for sub in SUBPACKAGES:
    assert any(m.startswith(f'mjlab_torch.{sub}.') for m in mods), sub
  for leaf in ('envs.manager_based_rl_env', 'envs.mdp.events',
               'managers.managers', 'tasks.velocity.config.g1.flat_env_cfg',
               'tasks.registry', 'rl.networks', 'scripts.play', 'sim.sim',
               'rl.config', 'rl.ppo', 'rl.runner', 'rl.writers', 'utils.cli',
               'utils.tables', 'scripts.train', 'rl.onnx_writer',
               'rl.exporter', 'scripts.demo', 'scripts.list_envs',
               'tasks.velocity.config.go1.flat_env_cfg',
               'asset_zoo.unitree_go1', 'scene.snapshot',
               'utils.actuator',
               'scripts.motion', 'tasks.tracking.tracking_env_cfg',
               'tasks.tracking.mdp.commands',
               'tasks.tracking.mdp.observations',
               'tasks.tracking.mdp.rewards',
               'tasks.tracking.mdp.terminations',
               'tasks.tracking.config.g1.flat_env_cfg',
               'asset_zoo.tiny_bot',
               'tasks.velocity.config.tiny', 'tasks.tracking.config.tiny',
               'parallel.sharding', 'asset_zoo.oracle_models',
               'physics.mesh', 'viewer.base', 'viewer.primitives',
               'viewer.debug_visualizer', 'viewer.offscreen',
               'viewer.native', 'viewer.viser_viewer', 'utils.hbm',
               'scripts.nan_viz', 'scripts.profile', 'utils.op_count',
               'ops.work'):
    assert f'mjlab_torch.{leaf}' in mods, leaf


def test_env_is_made_and_stepped_without_jax_or_mujoco(tmp_path):
  """The registry, the G1 flat env from the committed snapshot, a reset and
  a step under the shipped actor, the Go1 and the G1 tracking env (its
  default squat clip written by the port's motion pipeline into an empty
  cache), and the Tiny tasks through MJLAB_TASKS_MODULES (Flat-Tiny with
  the elliptic cone, Tracking-Tiny on a clip of write_tiny_motion), with
  jax, flax, orbax, the JAX package and mujoco all unimportable."""
  block = '; '.join(f'sys.modules[{b!r}] = None'
                    for b in BANNED + ('mujoco',))
  code = f"""
import sys; {block}
import torch
from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
from mjlab_torch.rl.networks import load_actor
from mjlab_torch.tasks import registry
assert 'Mjlab-Velocity-Flat-Unitree-G1-Play' in registry.registered_tasks()
env = registry.make('Mjlab-Velocity-Flat-Unitree-G1', device='cpu',
                    **{{'scene.num_envs': 2}})
actor = load_actor(G1_FLAT_POLICY, device='cpu')
obs, _ = env.reset()
obs, rew, term, trunc, extras = env.step(actor(obs))
assert obs['policy'].shape == (2, 99) and bool(torch.isfinite(rew).all())
go1 = registry.make('Mjlab-Velocity-Flat-Unitree-Go1', device='cpu',
                    **{{'scene.num_envs': 2}})
obs, _ = go1.reset()
obs, rew, term, trunc, extras = go1.step(torch.zeros(2, 12))
assert obs['policy'].shape == (2, 48) and bool(torch.isfinite(rew).all())
from mjlab_torch.asset_zoo.pretrained import G1_TRACKING_POLICY
track = registry.make('Mjlab-Tracking-Flat-Unitree-G1', device='cpu',
                      **{{'scene.num_envs': 2}})
assert track.cfg.commands.motion.motion_file.startswith({str(tmp_path)!r})
obs, _ = track.reset()
obs, rew, term, trunc, extras = track.step(
    load_actor(G1_TRACKING_POLICY, device='cpu')(obs))
assert obs['policy'].shape == (2, 160) and bool(torch.isfinite(rew).all())
import os
os.environ['MJLAB_TASKS_MODULES'] = ('mjlab_torch.tasks.velocity.config.tiny,'
                                     'mjlab_torch.tasks.tracking.config.tiny')
cfg = registry.load_cfg('Mjlab-Velocity-Flat-Tiny')
cfg.sim.mujoco.cone = 'elliptic'
tiny = registry.make('Mjlab-Velocity-Flat-Tiny', cfg=cfg, device='cpu',
                     **{{'scene.num_envs': 2}})
assert tiny.model.stat.cone == 1
obs, _ = tiny.reset()
obs, rew, term, trunc, extras = tiny.step(torch.zeros(2, 2))
assert obs['policy'].shape == (2, 18) and bool(torch.isfinite(rew).all())
from mjlab_torch.tasks.tracking.config.tiny import write_tiny_motion
cfg = registry.load_cfg('Mjlab-Tracking-Flat-Tiny')
cfg.commands.motion.motion_file = write_tiny_motion(
    {str(tmp_path / 'wave.npz')!r}, device='cpu')
tiny = registry.make('Mjlab-Tracking-Flat-Tiny', cfg=cfg, device='cpu',
                     **{{'scene.num_envs': 2}})
obs, _ = tiny.reset()
obs, rew, term, trunc, extras = tiny.step(torch.zeros(2, 2))
assert bool(torch.isfinite(rew).all())
loaded = [m for m in {BANNED + ('mujoco',)!r} if sys.modules.get(m)]
assert not loaded, loaded
print('ok')
"""
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=one_thread(MJLAB_TORCH_CACHE=str(tmp_path)))
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == 'ok'


def test_oracle_models_step_without_jax_or_mujoco():
  """The equality, tendon, mocap, sensor and collider oracle models (the
  convex pile and the mesh drop among them, their hulls built from the
  snapshots) load from their committed snapshots and step on the CPU with
  jax, the JAX package and mujoco all unimportable."""
  block = '; '.join(f'sys.modules[{b!r}] = None'
                    for b in BANNED + ('mujoco',))
  code = f"""
import sys; {block}
import torch
import mjlab_torch.physics as phys
from mjlab_torch.asset_zoo import oracle_models as om
for name in om.NAMES:
  m = phys.put_model(om.oracle_arrays(name), device='cpu')
  d = phys.make_batched_data(m, 2, device='cpu')
  for _ in range(2):
    d = phys.step(m, d)
  assert bool(torch.isfinite(d.qpos).all()), name
loaded = [m for m in {BANNED + ('mujoco',)!r} if sys.modules.get(m)]
assert not loaded, loaded
print('ok')
"""
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, env=one_thread(),
                       timeout=300)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == 'ok'


def test_mesh_hulls_build_without_jax_or_mujoco():
  """mjlab_torch.physics.mesh imports neither jax nor mujoco nor the JAX
  package, and builds the convex pile's hulls from its snapshot with all
  three unimportable (scipy's qhull is the one dependency)."""
  block = '; '.join(f'sys.modules[{b!r}] = None'
                    for b in BANNED + ('mujoco',))
  code = f"""
import sys; {block}
from mjlab_torch.physics import mesh
from mjlab_torch.asset_zoo import oracle_models as om
h = mesh.build_hulls(om.oracle_arrays('convex_pile'))
assert h.vert.shape == (2, mesh.MAX_HULL_VERT, 3) and (h.rin > 0).all()
loaded = [m for m in {BANNED + ('mujoco',)!r} if sys.modules.get(m)]
assert not loaded, loaded
print('ok')
"""
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, env=one_thread(),
                       timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == 'ok'


def test_viewer_and_guard_import_without_mujoco():
  """The viewer stack and the memory guard import with mujoco, viser,
  imageio, jax and the JAX package all unimportable, and a primitive is
  triangulated without mujoco."""
  block = '; '.join(f'sys.modules[{b!r}] = None' for b in BANNED + (
      'mujoco', 'mujoco.viewer', 'viser', 'imageio'))
  code = f"""
import sys; {block}
import mjlab_torch.viewer
from mjlab_torch.viewer import offscreen, primitives, viser_viewer
from mjlab_torch.utils import hbm
verts, faces = primitives.geom_mesh(3, [0.05, 0.2, 0])
assert verts.shape[1] == 3 and faces.shape[1] == 3
assert hbm.memory_report(lambda: None, device='cpu') is None
loaded = [m for m in {BANNED + ('mujoco', 'viser', 'imageio')!r}
          if sys.modules.get(m)]
assert not loaded, loaded
print('ok')
"""
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, env=one_thread(),
                       timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == 'ok'


def test_every_module_imports_without_jax():
  block = '; '.join(f'sys.modules[{b!r}] = None' for b in BANNED)
  imports = '; '.join(f'importlib.import_module({m!r})' for m in _modules())
  code = f'import importlib, sys; {block}; {imports}; print("ok")'
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, env=one_thread(),
                       timeout=120)
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == 'ok'


def test_train_help_imports_no_jax():
  """`scripts.train --help` (which lists --shard) runs with JAX and the JAX
  package unimportable, and so does importing mjlab_torch.parallel."""
  block = '; '.join(f'sys.modules[{b!r}] = None' for b in BANNED)
  code = (f'import runpy, sys; {block}; '
          'import mjlab_torch.parallel.sharding; '
          "sys.argv = ['train', '--help']; "
          "runpy.run_module('mjlab_torch.scripts.train', run_name='__main__')")
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, env=one_thread(),
                       timeout=120)
  assert out.returncode == 0, out.stderr
  assert '--shard' in out.stdout


def _python_files():
  yield os.path.join(ROOT, 'chip_smoke.py')
  for base, _, files in os.walk(os.path.join(ROOT, 'mjlab_torch')):
    for f in files:
      if f.endswith('.py'):
        yield os.path.join(base, f)


def test_no_jax_import_in_the_port_sources():
  for path in _python_files():
    with open(path) as f:
      tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or '']
      else:
        continue
      for name in names:
        assert name.split('.')[0] not in BANNED, (path, name)


def test_entry_points_default_to_cuda(monkeypatch):
  from mjlab_torch.scripts import profile
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    profile.main(['--num-envs', '2', '--reps', '1'])
  arrays = g1_flat_arrays()
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    tphys.put_model(arrays)
  m = tphys.put_model(arrays, device='cpu')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    tphys.make_batched_data(m, 2)
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    tphys.make_data(m)
  assert tphys.make_batched_data(m, 2, device='cpu').qpos.shape == (2, 36)


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
  """The runner's cfg, the ActorCritic loader and scripts/train.py want
  the GPU by default and raise on a host without CUDA; given 'cpu' they
  run there. A runner asked for a device other than its env's raises."""
  from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg
  from mjlab_torch.rl.networks import actor_critic_from_numpy
  from mjlab_torch.rl.runner import OnPolicyRunner
  from mjlab_torch.scripts import train
  from mjlab_torch.tasks import registry
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert RslRlOnPolicyRunnerCfg().device == 'cuda'
  env = registry.make('Mjlab-Velocity-Flat-Unitree-G1', device='cpu',
                      **{'scene.num_envs': 2})
  cfg = registry.load_cfg('Mjlab-Velocity-Flat-Unitree-G1',
                          'rl_cfg_entry_point')
  assert cfg.device == 'cuda'
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    OnPolicyRunner(env, cfg)
  dense = lambda a, b: {'kernel': np.zeros((a, b), np.float32),
                        'bias': np.zeros(b, np.float32)}
  params = {'params': {
      'actor': {'Dense_0': dense(3, 5), 'Dense_1': dense(5, 2)},
      'critic': {'Dense_0': dense(4, 1)}, 'std': np.ones(2, np.float32)}}
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    actor_critic_from_numpy(params)
  assert actor_critic_from_numpy(params, device='cpu').std_param.device \
      == torch.device('cpu')
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    train.main(['Mjlab-Velocity-Flat-Unitree-G1', '--log-root',
                str(tmp_path), '--env.scene.num_envs', '2'])
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  with pytest.raises(ValueError, match='the env lives on cpu'):
    OnPolicyRunner(env, cfg)


def test_kernel_wrappers_refuse_cpu_tensors():
  H = torch.eye(3).expand(2, 3, 3).contiguous()
  with pytest.raises(ValueError, match='CUDA tensor'):
    tpd.solve_pd_cuda(H, torch.zeros(2, 3))
  m = tphys.put_model(g1_flat_arrays(), device='cpu')
  d = tphys.make_batched_data(m, 2, device='cpu')
  with pytest.raises(ValueError, match='CUDA tensor'):
    tsk.smooth_fused_cuda(m, d.qpos, d.qvel)
  z = lambda *s: torch.zeros(s)
  with pytest.raises(ValueError, match='CUDA tensor'):
    tnewton.newton_solve_cuda(
        H, z(2, 3), z(2, 3), z(2, 4, 3), z(2, 4), z(2, 4), z(2, 4),
        z(2, 1), z(2, 1), z(2, 1), z(2, 1), z(2, 3), z(2, 3), z(2, 3),
        z(2, 3), iterations=2, ls_polish=1, ldof=(0,), grad_th=0.0)


def test_newton_kernel_needs_grad_th():
  """The convergence threshold is required: a default would silently turn
  off the plain solver's freeze rule."""
  H = torch.eye(3).expand(2, 3, 3).contiguous()
  z = lambda *s: torch.zeros(s)
  with pytest.raises(TypeError, match='grad_th'):
    tnewton.newton_solve_cuda(
        H, z(2, 3), z(2, 3), z(2, 4, 3), z(2, 4), z(2, 4), z(2, 4),
        z(2, 1), z(2, 1), z(2, 1), z(2, 1), z(2, 3), z(2, 3), z(2, 3),
        z(2, 3), iterations=2, ls_polish=1, ldof=(0,))


def test_cpu_step_never_asks_the_kernel_library(monkeypatch):
  """On CPU tensors every stage takes its plain version: neither a kernel
  nor the Newton fit gate (which asks the built library) is reached."""
  def no_library(name):
    raise AssertionError(f'kernel library {name!r} asked for on the CPU')
  monkeypatch.setattr(_build, 'library', no_library)
  m = tphys.put_model(g1_flat_arrays(), device='cpu')
  d = tphys.step(m, tphys.make_batched_data(m, 2, device='cpu'))
  assert bool(torch.isfinite(d.qpos).all())


@pytest.mark.parametrize('edit,rebuilds', [
    ('header', True), ('source', True), ('other_source', False),
    ('nothing', False)])
def test_build_target_follows_what_the_compiler_reads(tmp_path, monkeypatch,
                                                      edit, rebuilds):
  """A kernel library is named by its source, every shared header of csrc/
  and the flags: editing the header or the source renames it (so it is
  rebuilt), editing another source or nothing does not. No nvcc needed."""
  files = {'header': 'chol_warp.cuh', 'source': 'newton.cu',
           'other_source': 'smooth.cu'}
  (tmp_path / 'chol_warp.cuh').write_text('// header\n')
  (tmp_path / 'newton.cu').write_text('#include "chol_warp.cuh"\n')
  (tmp_path / 'smooth.cu').write_text('// other\n')
  monkeypatch.setattr(_build, 'CSRC', tmp_path)
  before = _build._target('newton')
  if edit != 'nothing':
    with open(tmp_path / files[edit], 'a') as f:
      f.write('// edited\n')
  assert (_build._target('newton') != before) == rebuilds


def test_shared_header_is_included_by_both_solvers():
  """K1 and K2 share one factor-and-solve routine, each with its own pivot
  rule."""
  for name, pivot in (('pd_solve.cu', 'PivotClamp'),
                      ('newton.cu', 'PivotRidge')):
    src = (_build.CSRC / name).read_text()
    assert '#include "chol_warp.cuh"' in src, name
    assert pivot in src, name


@pytest.mark.cuda
def test_newton_fit_rule():
  """G1 flat fits one block's shared memory; a self-collision-heavy model
  (ncr ~ 2400) does not and takes the plain path. The rule asks the built
  kernel library for its layout, so it needs the CUDA toolkit and a GPU."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU and the built kernel library')
  assert tnewton.fits(35, 144, 29)
  assert tnewton.newton_smem_bytes(35, 144, 29) < 48 * 1024
  assert not tnewton.fits(35, 2400, 29)
