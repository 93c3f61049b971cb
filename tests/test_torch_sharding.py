"""Multi-GPU training of the port (parallel/sharding.py, `train.py
--shard`) on the CPU, with 2 gloo ranks started by
`torch.distributed.run`; the counterpart of tests/test_sharding.py.

- the world's rules: `assert_divisible` (12 envs over 8 ranks raises),
  `shard_batched` never slices a (num_envs, h) parameter, the backend rule
  (cards told apart by UUID), a failed process-group start raises,
  gather_env refuses a leaf it cannot place, the terms of the Go1 and
  Tracking-Tiny envs name the state every rank holds alike;
- shard-aware draws: a rank's rows of each draw are the rows of the
  one-process draw, bit for bit, and the ranks' generators stay in step;
- Rough-Tiny built as rank 1 of 2 at 16 envs (no process group) holds the
  full env's rows of origins, levels, types and startup draws, exactly;
- the learner: the port's 2-rank iteration of the toy env of
  tests/test_torch_rl.py (16 envs, actions clipped to 0, one minibatch)
  against the JAX package's `enable_sharding` iteration over the 8 virtual
  CPU devices, from one carried JAX TrainState; logs within 1e-5, the
  learner by test_torch_rl._check_learner's rule, both ranks' parameters
  identical to the bit;
- Flat-Tiny (16 envs, float64, every range a point, actions clipped to 0,
  one env tipped over on rank 1): 2 iterations of the 2-rank run against
  the 1-process run: the env's rows of the rollout within 1e-9, the
  network's outputs, advantages and logs within 1e-5, Adam's moments and
  the normalizers as _check_learner holds them, every parameter within
  Adam's sign-step bound (2 lr a step) and all but 1e-3 of them within
  1e-6 (the reduction order of the ranks' gradients moves a few elements
  whose gradient is near 0 by more; measured: 15 of 131,072 in one layer,
  1.6e-5), both ranks' learners identical to the bit, their generators in
  step;
- the exploration noise: the toy env's iteration with the actions not
  clipped, 2 ranks against 1 process: the noisy actions and what they earn
  within 1e-5;
- resume: a 2-rank runner loads a checkpoint's learner, read by rank 0
  alone, to the bit on both ranks;
- Tracking-Tiny: the bin failures and start steps after a reset with one
  failing env on each rank equal the 1-process run's;
- the CLI: `torch.distributed.run --nproc_per_node 2 -m
  mjlab_torch.scripts.train Mjlab-Velocity-Flat-Tiny --device cpu --shard`
  writes one run directory and one checkpoint of all 16 envs, which a
  1-process run resumes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_torch.tasks.tracking.config.tiny  # noqa: F401 (registers)
import mjlab_torch.tasks.velocity.config.tiny  # noqa: F401 (registers)
import torch_parity  # noqa: F401  (one intra-op thread)
import torch_shard_workers as W
from mjlab_torch.parallel import sharding as tsh
from mjlab_torch.rl import ppo as tppo_mod
from mjlab_torch.utils import math as tmath
from mjlab_tpu.parallel.sharding import enable_sharding as jax_sharding
from mjlab_tpu.rl import ppo as jppo_mod
from mjlab_tpu.rl.config import RslRlOnPolicyRunnerCfg as JaxCfg
from test_torch_rl import _check_learner, _close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
N = W.N


def _env() -> dict:
  return {**os.environ, 'MJLAB_TASKS_MODULES': W.MODULES,
          'OMP_NUM_THREADS': '1',
          'PYTHONPATH': os.pathsep.join([ROOT, os.path.join(ROOT, 'tests')])}


def _torchrun(*args, timeout=300):
  cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
         '2', '--master_addr', '127.0.0.1', '--master_port',
         str(tsh.free_port()), *args]
  out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True,
                       text=True, timeout=timeout)
  assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
  return out


class JaxToyEnv:
  """The toy env of tests/test_torch_rl.py on jax.numpy, at 16 envs."""

  num_envs = N
  action_dim = W.ACTION_DIM
  observation_dims = {'policy': W.POLICY_DIM, 'critic': W.CRITIC_DIM}
  step_dt = 0.02

  def __init__(self):
    self.table = jnp.asarray(W.TABLE)

  def _obs(self, k):
    row = self.table[k % W.NSTEP_TABLE]
    return {'policy': row[:, :W.POLICY_DIM],
            'critic': row[:, W.POLICY_DIM:W.POLICY_DIM + W.CRITIC_DIM]}

  def init_state(self, seed=0):
    del seed
    state = {'k': jnp.zeros((), jnp.int32),
             't': jnp.arange(N, dtype=jnp.int32) % 3}
    return state, self._obs(state['k'])

  @property
  def step_fn(self):
    def step(state, action):
      k, t = state['k'], state['t']
      row = self.table[k % W.NSTEP_TABLE]
      reward = (-jnp.sum(jnp.square(action - row[:, :2]), axis=-1)
                + 0.1 * row[:, W.POLICY_DIM]).astype(jnp.float32)
      t = t + 1
      truncated = t >= 3
      terminated = (row[:, -1] > 1.0) & ~truncated
      done = truncated | terminated
      f = lambda x: jnp.sum(x).astype(jnp.float32)
      extras = {
          'time_outs': truncated,
          'reset_count': f(done),
          'episode_length_sum': f(jnp.where(done, t, 0)),
          'Episode_Termination/time_out': f(truncated),
          'Episode_Termination/bad': f(terminated),
          'Episode_Reward/r': f(jnp.where(done, reward, 0.0))
          / jnp.maximum(f(done), 1.0),
      }
      state = {'k': k + 1, 't': jnp.where(done, 0, t)}
      return state, (self._obs(k + 1), reward, terminated, truncated, extras)
    return step


@pytest.fixture(scope='module')
def jax_toy():
  jppo = jppo_mod.PPO(JaxToyEnv(), W.toy_cfg(JaxCfg))
  return jppo, jppo.init_state(0)


@pytest.fixture(scope='module')
def runs(tmp_path_factory, jax_toy):
  """One 2-rank run of every scenario of tests/torch_shard_workers.py: the
  toy learner from the JAX learner's initial state, Flat-Tiny and
  Tracking-Tiny. Returns (job, [rank 0's results, rank 1's])."""
  from mjlab_torch.tasks.tracking.config.tiny import write_tiny_motion
  tmp = tmp_path_factory.mktemp('shard')
  _, jts = jax_toy
  host = jax.device_get(jts)
  tppo = tppo_mod.PPO(W.TorchToyEnv(tsh.World(N, CPU)), W.toy_cfg())
  t = lambda x: torch.from_numpy(np.array(x))
  tts = tppo_mod.train_state_from_numpy(
      tppo, host, env_state={k: t(v) for k, v in host.env_state.items()},
      obs={k: t(v) for k, v in host.obs.items()})
  job = {
      'toy': {'learner': [x.clone() for x in
                          tppo_mod.learner_tensors(tts)],
              'env_state': tts.env_state, 'obs': tts.obs,
              'iteration': tts.iteration},
      'toy_noise': True,
      'resume': True,
      'flat_tiny': True,
      'tracking_tiny': write_tiny_motion(str(tmp / 'wave.npz'),
                                         device='cpu'),
  }
  torch.save(job, tmp / 'job.pt')
  _torchrun(os.path.join(ROOT, 'tests', 'torch_shard_workers.py'),
            str(tmp / 'job.pt'), str(tmp))
  ranks = [torch.load(tmp / f'rank{r}.pt', weights_only=True)
           for r in range(2)]
  assert [r['world'] for r in ranks] == [(0, 2, 'gloo'), (1, 2, 'gloo')]
  return job, ranks


def _rows(rank: int) -> slice:
  return slice(rank * N // 2, (rank + 1) * N // 2)


def _same_learner(a: dict, b: dict) -> bool:
  """Two learner_state dicts identical to the bit."""
  if isinstance(a, dict):
    return a.keys() == b.keys() and all(_same_learner(a[k], b[k])
                                        for k in a)
  return torch.equal(a, b) if torch.is_tensor(a) else a == b


def _learner_ts(ppo, state: dict):
  """A fresh TrainState of `ppo` holding a learner_state dict."""
  ts = ppo.init_state()
  with torch.no_grad():
    for k, p in ts.net.named_parameters():
      p.copy_(state['params'][k])
    for name in ('actor_norm', 'critic_norm'):
      for k, b in getattr(ts, name).named_buffers():
        b.copy_(state[name][k])
  ts.adam = tppo_mod.AdamState(count=state['count'], mu=state['mu'],
                               nu=state['nu'])
  ts.lr = state['lr']
  ts.iteration = state['iteration']
  return ts


# ---------------------------------------------------------------------------
# the world's rules


def test_num_envs_must_divide_over_the_ranks():
  tsh.assert_divisible(16, 8)
  with pytest.raises(ValueError, match='not divisible'):
    tsh.assert_divisible(12, 8)
  with pytest.raises(ValueError, match='not divisible'):
    tsh.World(12, CPU, rank=0, size=8)
  # before any process group is asked for
  with pytest.raises(ValueError, match='not divisible'):
    tsh.init_world(12, 'cpu', rank=0, size=8)


def test_shard_batched_never_slices_parameters():
  """A (num_envs, h) weight, optimizer and normalizer leaves (the learner
  roots, matched at the root of the tree only) and the env state's leaves
  that its terms name replicated (the curriculum's ranges, the motion clip,
  given as paths) stay whole; env-axis leaves are cut to the rank's rows,
  also where a key below the root is named like a learner root; other
  shapes stay."""
  world = tsh.World(8, CPU, rank=1, size=2)
  tree = {
      'params': {'w': torch.ones((8, 3))},  # adversarial shape
      'opt_state': [torch.ones(8)],
      'adam': {'mu': {'w': torch.ones(8, 3)}},
      'actor_norm': {'mean': torch.zeros(8)},
      'env_state': {
          'qpos': torch.arange(40.0).reshape(8, 5),
          'common_step': np.int32(3),
          'curriculum': {'c': {'range_lin_vel_x': np.zeros(8)}},
          'command': {'motion': {'motion/joint_pos': np.zeros((8, 2)),
                                 'time_steps': np.arange(8),
                                 'bin_failed': np.zeros(8)}},
          'event': {'lr': np.arange(8), 'gen': {'x': np.arange(8)}},
          'other': np.zeros((3, 8))},
  }
  paths = frozenset({'env_state/curriculum/c/range_lin_vel_x',
                     'env_state/command/motion/bin_failed',
                     'env_state/command/motion/motion/'})
  out = tsh.shard_batched(tree, world, replicated_paths=paths)
  assert out['params']['w'] is tree['params']['w']
  assert out['opt_state'][0].shape == (8,)
  assert out['adam']['mu']['w'].shape == (8, 3)
  assert out['actor_norm']['mean'].shape == (8,)
  env = out['env_state']
  assert torch.equal(env['qpos'], torch.arange(20.0, 40.0).reshape(4, 5))
  assert env['curriculum']['c']['range_lin_vel_x'].shape == (8,)
  motion = env['command']['motion']
  assert motion['motion/joint_pos'].shape == (8, 2)
  assert motion['bin_failed'].shape == (8,)
  np.testing.assert_array_equal(motion['time_steps'], np.arange(4, 8))
  np.testing.assert_array_equal(env['event']['lr'], np.arange(4, 8))
  np.testing.assert_array_equal(env['event']['gen']['x'], np.arange(4, 8))
  assert env['other'].shape == (3, 8)
  # without the paths the env state's every (8, ...) leaf is per-env
  plain = tsh.shard_batched(tree, world)['env_state']
  assert plain['command']['motion']['bin_failed'].shape == (4,)


def test_gather_refuses_a_leaf_it_cannot_place():
  """Every leaf of a checkpoint's env state is on the env axis, 0-d or
  named replicated; any other is an error, not a guess. A collective over
  ranks without their process group raises."""
  world = tsh.World(16, CPU, rank=0, size=2)
  paths = frozenset({'command/m/bin_failed'})
  ok = {'data': {'qpos': np.zeros((8, 3))}, 'common_step': np.int32(0),
        'command': {'m': {'bin_failed': np.zeros(5)}}}
  tsh.check_env_axes(ok, world, replicated_paths=paths)
  with pytest.raises(ValueError, match='command/m/bin_failed'):
    tsh.check_env_axes(ok, world)
  with pytest.raises(ValueError, match='command/m/clip'):
    tsh.check_env_axes({**ok, 'command': {'m': {'clip': np.zeros(5)}}},
                       world, replicated_paths=paths)
  with pytest.raises(ValueError, match='process group'):
    tsh.gather_env(ok, world, replicated_paths=paths)
  with pytest.raises(ValueError, match='process group'):
    tsh.all_reduce_flat([torch.ones(2)], world)
  one = tsh.World(16, CPU)
  assert not one.sharded and world.sharded
  assert tsh.gather_env(ok, one) is ok
  assert torch.equal(tsh.all_reduce_flat([torch.ones(2)], one)[0],
                     torch.ones(2))


@pytest.mark.parametrize('task,paths', [
    ('Mjlab-Velocity-Flat-Unitree-Go1',
     {'curriculum/command_vel/range_lin_vel_x',
      'curriculum/command_vel/range_ang_vel_z'}),
    (W.TRACK, {'command/motion/bin_failed',
               'command/motion/current_bin_failed', 'command/motion/motion/'}),
])
def test_terms_name_the_state_every_rank_holds(tmp_path, task, paths):
  """An env built as rank 0 of 2 (8 envs, no process group) names, from
  its terms' `replicated_state`, the paths of its state that are no
  per-env rows; with them every leaf of its state passes check_env_axes,
  without them the first of them does not. A reset of this env raises:
  its bin failures need the ranks' process group."""
  from mjlab_torch.envs.io import env_state_to_numpy
  from mjlab_torch.tasks import registry
  from mjlab_torch.tasks.tracking.config.tiny import write_tiny_motion
  cfg = registry.load_cfg(task)
  cfg.scene.num_envs = 8
  if task == W.TRACK:
    cfg.commands.motion.motion_file = write_tiny_motion(
        str(tmp_path / 'wave.npz'), device='cpu')
  world = tsh.World(8, CPU, rank=0, size=2)
  env = registry.make(task, cfg=cfg, device='cpu', world=world)
  assert env.replicated_state == paths
  # the template state: a reset of Tracking-Tiny reduces its bin failures
  # over the ranks, which a world without a process group cannot
  state = env_state_to_numpy(env._template_state, env)
  tsh.check_env_axes(state, world, replicated_paths=env.replicated_state)
  with pytest.raises(ValueError, match=sorted(paths)[0].rstrip('/')):
    tsh.check_env_axes(state, world)
  if task == W.TRACK:
    with pytest.raises(ValueError, match='process group'):
      env.init_state()


def test_backend_rule(monkeypatch):
  """NCCL only when no two ranks share a card, told apart by host and
  UUID: ranks that each see one card of their own (a launcher's
  CUDA_VISIBLE_DEVICES a rank) are on NCCL, two ranks on one card on gloo;
  gloo on the CPU (rank i takes card i mod count)."""
  assert tsh.backend_for('cpu', ['h/cpu', 'g/cpu']) == 'gloo'
  assert tsh.rank_device('cpu', 1) == CPU
  assert tsh.card_key('cpu').endswith('/cpu')
  assert tsh.backend_for('cuda', ['h/GPU-a']) == 'nccl'
  assert tsh.backend_for('cuda', ['h/GPU-a', 'h/GPU-a']) == 'gloo'
  assert tsh.backend_for('cuda', ['h/GPU-a', 'h/GPU-b', 'g/GPU-c']) == 'nccl'
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
  assert tsh.rank_device('cuda', 1) == torch.device('cuda', 0)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
  assert tsh.rank_device('cuda', 1) == torch.device('cuda', 1)
  uuids = {0: 'GPU-a', 1: 'GPU-b'}
  monkeypatch.setattr(torch.cuda, 'get_device_properties',
                      lambda d: type('P', (), {'uuid': uuids[d.index]}))
  keys = [tsh.card_key(torch.device('cuda', i)) for i in (0, 1)]
  assert keys[0].endswith('/GPU-a') and keys[1].endswith('/GPU-b')
  assert tsh.backend_for('cuda', keys) == 'nccl'


@pytest.mark.parametrize('how', ['no address', 'no peer'])
def test_failed_start_raises(monkeypatch, how):
  """A process group that cannot start raises; nothing drops to a world
  of one."""
  import torch.distributed as dist
  for k in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE'):
    monkeypatch.delenv(k, raising=False)
  with pytest.raises((ValueError, RuntimeError)):
    if how == 'no address':
      tsh.init_world(16, 'cpu', rank=0, size=2)
    else:  # rank 0 of 2 waits for a rank 1 that never comes
      tsh.init_world(16, 'cpu', rank=0, size=2, timeout_s=2,
                     init_method=f'tcp://127.0.0.1:{tsh.free_port()}')
  assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# shard-aware draws


@pytest.mark.parametrize('kind', ['uniform', 'log_uniform', 'gaussian',
                                  'randint', 'multinomial'])
def test_rank_draws_are_rows_of_the_one_process_draw(kind):
  """4 ranks of 12 envs: each rank's draw of an env-axis shape is its rows
  of the one-process draw, bit for bit; a draw of another shape is the
  one-process draw whole; every rank's generator ends where the
  one-process generator does."""
  p = torch.tensor([0.2, 0.5, 0.3])
  draws = {
      'uniform': lambda g, s: tmath.sample_uniform(g, -1.0, 2.0, s),
      'log_uniform': lambda g, s: tmath.sample_log_uniform(g, 0.5, 2.0, s),
      'gaussian': lambda g, s: tmath.sample_gaussian(g, 0.3, 2.0, s),
      'randint': lambda g, s: tmath.env_rows(
          g, lambda s_: torch.randint(0, 7, s_, generator=g), s),
      'multinomial': lambda g, s: tmath.env_rows(
          g, lambda s_: torch.multinomial(p, s_[0], replacement=True,
                                          generator=g), s[:1] or (1,)),
  }[kind]
  shapes = [(12,), (12, 2), (), (5,), (12, 3)]
  one = torch.Generator().manual_seed(5)
  want = [draws(one, s) for s in shapes]
  for rank in range(4):
    gen = tmath.ShardedGenerator('cpu', (3 * rank, 3, 12))
    gen.manual_seed(5)
    for s, w in zip(shapes, want):
      got = draws(gen, (3,) + s[1:] if s[:1] == (12,) else s)
      rows = w[3 * rank:3 * rank + 3] if s[:1] == (12,) else w
      assert torch.equal(got, rows), (kind, rank, s)
    assert torch.equal(gen.get_state(), one.get_state()), (kind, rank)


def test_rough_tiny_rank_holds_the_global_rows():
  """Rough-Tiny at 16 envs built as rank 1 of 2, with no process group:
  its origins, terrain levels and types, its startup foot friction and
  its reset state are rows 8..15 of the full env's (the state within
  1e-12: its physics is batched at another size)."""
  from mjlab_torch.envs.io import env_state_to_numpy
  from mjlab_torch.tasks import registry

  def make(world):
    cfg = registry.load_cfg('Mjlab-Velocity-Rough-Tiny')
    cfg.scene.num_envs = N
    gen = cfg.scene.terrain.terrain_generator
    gen.size, gen.border_width, gen.num_rows, gen.num_cols = (
        (2.0, 2.0), 1.0, 2, 3)
    return registry.make('Mjlab-Velocity-Rough-Tiny', cfg=cfg, device='cpu',
                         dtype=torch.float64, world=world)

  full = make(None)
  part = make(tsh.World(N, CPU, rank=1, size=2))
  rows = _rows(1)
  assert part.num_envs == 8 and full.num_envs == N
  ft, pt = full.scene.terrain, part.scene.terrain
  np.testing.assert_array_equal(pt.env_origins, ft.env_origins[rows])
  np.testing.assert_array_equal(pt.terrain_levels, ft.terrain_levels[rows])
  np.testing.assert_array_equal(pt.terrain_types, ft.terrain_types[rows])
  assert len(set(ft.terrain_types.tolist())) == 3
  assert torch.equal(part.scene.env_origins, full.scene.env_origins[rows])
  assert torch.equal(part.model.geom_friction,
                     full.model.geom_friction[rows])
  assert len(set(full.model.geom_friction[:, :, 0].flatten().tolist())) > 2
  fs = env_state_to_numpy(full.init_state()[0], full)
  ps = env_state_to_numpy(part.init_state()[0], part)

  def compare(a, b, path=''):
    if isinstance(a, dict):
      for k in a:
        compare(a[k], b[k], f'{path}/{k}')
      return
    a, b = np.asarray(a), np.asarray(b)
    if b.ndim and b.shape[0] == N and not path.endswith('common_step'):
      b = b[rows]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, err_msg=path)

  levels = lambda env: env._template_state.curriculum['terrain_levels'][
      'levels'].numpy()
  np.testing.assert_array_equal(levels(part), ft.terrain_levels[rows])
  np.testing.assert_array_equal(levels(full), ft.terrain_levels)
  compare(ps, fs)


# ---------------------------------------------------------------------------
# the learner


def test_two_rank_iteration_matches_jax_sharded(runs, jax_toy):
  """The toy env's iteration, 2 gloo ranks of the port against the JAX
  package's enable_sharding over its 8 virtual CPU devices, both from the
  same JAX TrainState: each rank's rollout rows (observations and flags
  exactly, network outputs and rewards within 1e-6), every log within
  1e-5, rank 0's learner by _check_learner's rule, rank 1's identical to
  rank 0's to the bit."""
  job, ranks = runs
  jppo, jts = jax_toy
  mesh, jts_sh, restore = jax_sharding(jts, N, 8)
  try:
    assert mesh.shape['env'] == 8
    jtraj = jax.device_get(jax.jit(jppo._rollout)(jts_sh)[3])
    jts_out, jlogs = jppo.learn_iteration(jts_sh)
    jlogs = jax.device_get(jlogs)
  finally:
    restore.__exit__(None, None, None)
  for rank, res in enumerate(ranks):
    toy = res['toy']
    rows = _rows(rank)
    for k in ('actor_obs', 'critic_obs', 'action', 'done', 'time_out'):
      np.testing.assert_array_equal(
          toy['storage'][k].numpy(), np.asarray(getattr(jtraj, k))[:, rows],
          err_msg=f'rank {rank}: {k}')
    assert bool(toy['storage']['done'].any())
    for k in ('logprob', 'mean', 'value', 'reward'):
      _close(toy['storage'][k], np.asarray(getattr(jtraj, k))[:, rows],
             1e-6, f'rank {rank}: {k}')
    assert set(toy['logs']) == set(jlogs) - {'_qpos_env0'}
    for k, v in toy['logs'].items():
      _close(torch.tensor(v), jlogs[k], 1e-5, f'rank {rank}: log {k}')
  assert _same_learner(ranks[0]['toy']['learner'], ranks[1]['toy']['learner'])
  assert torch.equal(ranks[0]['toy']['gen'], ranks[1]['toy']['gen'])
  tppo = tppo_mod.PPO(W.TorchToyEnv(tsh.World(N, CPU)), W.toy_cfg())
  _check_learner(_learner_ts(tppo, ranks[0]['toy']['learner']), jts_out,
                 'rank 0', 2, tppo.cfg.algorithm.learning_rate)


def test_action_noise_is_the_one_process_rows(runs):
  """The toy env's iteration with the actions not clipped, from the
  port's own seeded state: each rank's rollout rows (the noisy actions,
  their log-probabilities, the rewards they earn) are the 1-process run's
  within 1e-5 of their scale, so every env explores with its own noise of
  the one-process run (a rank that drew its own rows' noise would repeat
  rank 0's); logs within 1e-5, the learner as _learner_close says, both
  ranks' learners and generators identical."""
  _, ranks = runs
  ref = W.toy_noise(tsh.World(N, CPU))
  noise = ref['storage']['action'] - ref['storage']['mean']
  assert float(noise.abs().min()) > 0 and float(noise.std()) > 0.3
  lr = float(ref['learner']['lr'])
  for rank, res in enumerate(ranks):
    got, rows, what = res['toy_noise'], _rows(rank), f'rank {rank}'
    for k in ('action', 'logprob', 'mean', 'value', 'reward', 'done'):
      _close(got['storage'][k].double(),
             ref['storage'][k][:, rows].double().numpy(), 1e-5,
             f'{what}: {k}')
    for k, v in ref['logs'].items():
      if not k.endswith('_ms'):
        _close(torch.tensor(got['logs'][k]), v, 1e-5, f'{what}: log {k}')
    _learner_close(got['learner'], ref['learner'], lr, 2, what)
  a, b = (r['toy_noise'] for r in ranks)
  assert _same_learner(a['learner'], b['learner'])
  assert torch.equal(a['gen'], b['gen'])


def _learner_close(got: dict, want: dict, lr: float, steps: int,
                   what: str) -> None:
  """Adam's count equal, its moments within 1e-5 of their scale, the
  normalizers and lr within 1e-6; every parameter within Adam's sign-step
  bound of 2 lr a step, and all but 1e-3 of each tensor's elements within
  1e-6."""
  assert torch.equal(got['count'], want['count']), what
  for k, p in want['params'].items():
    _close(got['mu'][k], want['mu'][k], 1e-5, f'{what}: mu {k}')
    _close(got['nu'][k], want['nu'][k], 1e-5, f'{what}: nu {k}')
    diff = (got['params'][k] - p).abs()
    assert float(diff.max()) <= 2 * lr * steps + 1e-6, (what, k)
    assert float((diff > 1e-6).double().mean()) <= 1e-3, (what, k)
  for name in ('actor_norm', 'critic_norm'):
    for k, v in want[name].items():
      _close(got[name][k], v, 1e-6, f'{what}: {name} {k}')
  _close(got['lr'], want['lr'], 1e-6, f'{what}: lr')
  assert got['iteration'] == want['iteration'], what


def test_flat_tiny_two_ranks_match_one_process(runs):
  """Two iterations of Flat-Tiny (16 envs, float64, every range a point,
  actions clipped to 0, env 12 tipped over on rank 1, so that only rank 1
  resets at the first env-step and rank 0 must refresh all the same): the
  2-rank run against the 1-process run. The env's rows of the rollout
  (observations, actions, rewards, flags) within 1e-9; the network's
  outputs, advantages and returns within 1e-5 (float32 products of another
  batch size); logs within 1e-5; the learner as _learner_close says; both
  ranks' learners and generators identical."""
  _, ranks = runs
  ref = W.flat_tiny(tsh.World(N, CPU))
  assert ref[0]['logs']['Episode_Termination/fell_over'] == 1.0
  lr0 = float(ref[0]['learner']['lr'])
  for it in range(2):
    want = ref[it]
    for rank, res in enumerate(ranks):
      got, rows, what = res['flat_tiny'][it], _rows(rank), f'it {it + 1}, ' \
          f'rank {rank}'
      for k in ('actor_obs', 'critic_obs', 'action', 'reward', 'done',
                'time_out'):
        _close(got['storage'][k].double(),
               want['storage'][k][:, rows].double().numpy(), 1e-9,
               f'{what}: {k}')
      for k in ('logprob', 'mean', 'value'):
        _close(got['storage'][k], want['storage'][k][:, rows].numpy(), 1e-5,
               f'{what}: {k}')
      _close(got['advantages'], want['advantages'][:, rows].numpy(), 1e-5,
             f'{what}: advantages')
      _close(got['returns'], want['returns'][:, rows].numpy(), 1e-5,
             f'{what}: returns')
      assert set(got['logs']) == set(want['logs'])
      for k, v in want['logs'].items():
        if not k.endswith('_ms'):
          _close(torch.tensor(got['logs'][k]), v, 1e-5, f'{what}: log {k}')
      assert torch.equal(got['env_gen'], want['env_gen']), what
      _learner_close(got['learner'], want['learner'], lr0, 2 * (it + 1),
                     what)
    a, b = (r['flat_tiny'][it] for r in ranks)
    assert _same_learner(a['learner'], b['learner']), it
    assert torch.equal(a['gen'], b['gen']), it


def test_resume_reads_the_learner_on_rank_0(runs):
  """A 2-rank runner of another seed loads a 2-rank checkpoint's learner,
  which rank 0 alone reads and sends: on both ranks the parameters, Adam,
  the normalizers, the learning rate, the iteration and the learner's
  generator are the saved ones, to the bit."""
  _, ranks = runs
  saved = ranks[0]['resume']['saved']
  assert saved['iteration'] == 5
  for rank, res in enumerate(ranks):
    got = res['resume']
    assert _same_learner(got['loaded'], saved), rank
    assert torch.equal(got['loaded_gen'], ranks[0]['resume']['saved_gen'])


def test_tracking_bin_failures_are_global(runs):
  """Tracking-Tiny, one env tipped over on each rank: after the step that
  resets them, every rank's bin failures are the 1-process run's (each
  rank's own failure and the other's), and so are its rows of the start
  steps drawn from them, the flags and the observations."""
  job, ranks = runs
  ref = W.tracking_tiny(tsh.World(N, CPU), job['tracking_tiny'])
  assert ref['terminated'].nonzero().flatten().tolist() == list(W.TRACK_TIPS)
  assert float(ref['bin_failed'].sum()) > 0
  for rank, res in enumerate(ranks):
    got, rows = res['tracking_tiny'], _rows(rank)
    assert torch.equal(got['bin_failed'], ref['bin_failed']), rank
    assert torch.equal(got['current_bin_failed'], ref['current_bin_failed'])
    assert torch.equal(got['time_steps'], ref['time_steps'][rows]), rank
    assert torch.equal(got['terminated'], ref['terminated'][rows]), rank
    _close(got['obs'], ref['obs'][rows].numpy(), 1e-9, f'rank {rank}: obs')


# ---------------------------------------------------------------------------
# the entry point


def test_cli_trains_sharded_and_resumes_in_one_process(tmp_path):
  """`torch.distributed.run --nproc_per_node 2 -m mjlab_torch.scripts.train
  Mjlab-Velocity-Flat-Tiny --device cpu --shard`, one iteration: rank 0
  writes the one run directory, logs once and saves one checkpoint that
  holds all 16 envs; a 1-process runner loads it (learner and env state),
  and a 1-process `train.main --resume` goes on from it."""
  from mjlab_torch.rl.runner import OnPolicyRunner
  from mjlab_torch.scripts import train
  from mjlab_torch.tasks import registry
  args = ['--device', 'cpu', '--log-root', str(tmp_path),
          '--env.scene.num_envs', str(N), '--agent.max_iterations', '1',
          '--agent.num_steps_per_env', '4']
  out = _torchrun('-m', 'mjlab_torch.scripts.train', W.FLAT, '--shard',
                  '--run-name', 'sharded', *args)
  assert 'world of 2 over gloo' in out.stdout
  assert sum(line.startswith('it ') for line in out.stdout.splitlines()) == 1
  run = tmp_path / 'tiny_velocity' / 'sharded'
  assert os.listdir(tmp_path / 'tiny_velocity') == ['sharded']
  assert sorted(os.listdir(run)) == [
      'agent_cfg.json', 'env_cfg.json', 'metrics.jsonl', 'model_1.onnx',
      'model_1.onnx.meta.json', 'model_1.pt']
  logs = [json.loads(x) for x in (run / 'metrics.jsonl').read_text()
          .splitlines()]
  assert [x['iteration'] for x in logs] == [1]
  assert logs[0]['total_env_steps'] == 4 * N
  ckpt = torch.load(run / 'model_1.pt', weights_only=True)
  assert {v.shape[0] for v in ckpt['obs'].values()} == {N}
  qpos = ckpt['env_state']['data']['qpos']
  assert qpos.shape[0] == N
  assert ckpt['env_state']['episode_length'].shape == (N,)

  env = registry.make(W.FLAT, device='cpu', **{'scene.num_envs': N})
  cfg = registry.load_cfg(W.FLAT, 'rl_cfg_entry_point')
  cfg.device = 'cpu'
  runner = OnPolicyRunner(env, cfg)
  runner.load(str(run / 'model_1.pt'), load_env_state=True)
  assert runner.ts.iteration == 1
  for k, p in runner.ts.net.named_parameters():
    assert torch.equal(p.detach(), ckpt['params'][k]), k
  assert torch.equal(runner.ts.env_state.data.qpos.float(), qpos.float())
  resumed = train.main([W.FLAT, '--run-name', 'resumed', '--resume',
                        *args])
  assert resumed.ts.iteration == 2
  assert os.path.exists(tmp_path / 'tiny_velocity' / 'resumed' /
                        'model_2.pt')


def test_world_of_one_is_the_unsharded_run(tmp_path):
  """`train.main --shard` on the CPU without a launcher: a world of one
  gloo process, whose collectives and merges return its own values, so
  that its checkpoint's learner and env state and its logs are the
  unsharded run's to the bit."""
  from mjlab_torch.scripts import train
  args = [W.FLAT, '--device', 'cpu', '--log-root', str(tmp_path),
          '--env.scene.num_envs', '4', '--agent.max_iterations', '1',
          '--agent.num_steps_per_env', '4']
  sharded = train.main(args + ['--shard', '--run-name', 'one'])
  assert sharded.world.size == 1 and sharded.world.backend == 'gloo'
  train.main(args + ['--run-name', 'plain'])
  run = tmp_path / 'tiny_velocity'
  a, b = (torch.load(run / r / 'model_1.pt', weights_only=True)
          for r in ('one', 'plain'))

  def same(x, y):
    if isinstance(x, dict):
      return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
    return torch.equal(x, y) if torch.is_tensor(x) else x == y

  assert same(a, b)
  la, lb = (json.loads((run / r / 'metrics.jsonl').read_text())
            for r in ('one', 'plain'))
  assert {k: v for k, v in la.items() if not k.endswith(('_ms', '_s'))} == \
      {k: v for k, v in lb.items() if not k.endswith(('_ms', '_s'))}
