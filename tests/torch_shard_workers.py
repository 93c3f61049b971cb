"""The sharded runs of tests/test_torch_sharding.py, one rank a process:

    python -m torch.distributed.run --nproc_per_node 2 \\
        tests/torch_shard_workers.py JOB OUT

JOB is a `torch.save`d dict naming the scenarios to run and their inputs;
each rank writes what it computed to OUT/rank<r>.pt. Every scenario is a
function of a `World`, so that the tests run it in one process too (a
World without a process group) for the reference. Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from chip_smoke import degenerate_ranges, tip_over_state
from mjlab_torch.parallel.sharding import (
    World,
    close_world,
    enable_sharding,
    init_world,
)
from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg as TorchCfg
from mjlab_torch.rl.ppo import PPO, learner_tensors
from mjlab_torch.tasks import registry

N = 16  # global envs of every scenario: 2 ranks, and 8 JAX devices
NSTEP_TABLE = 64
POLICY_DIM, CRITIC_DIM, ACTION_DIM = 5, 3, 2
# the toy env's table (tests/test_torch_rl.py's toy env at 16 envs)
TABLE = np.random.default_rng(7).normal(
    size=(NSTEP_TABLE, N, POLICY_DIM + CRITIC_DIM + 1)).astype(np.float32)
FLAT = 'Mjlab-Velocity-Flat-Tiny'
TRACK = 'Mjlab-Tracking-Flat-Tiny'
MODULES = ('mjlab_torch.tasks.velocity.config.tiny,'
           'mjlab_torch.tasks.tracking.config.tiny')
FLAT_STEPS = 8  # env-steps an iteration of the Flat-Tiny runs
FLAT_TIP = 12  # the Flat-Tiny env tipped over: rank 1's, of 2
TRACK_TIPS = (3, 12)  # the Tracking-Tiny envs tipped over: one a rank


def toy_cfg(cls=TorchCfg):
  """tests/test_torch_rl.py's toy cfg (either package's class): actions
  clipped to 0, fixed schedule, one minibatch, two epochs."""
  cfg = cls(num_steps_per_env=4, clip_actions=0.0, seed=3)
  cfg.policy.actor_hidden_dims = (16, 8)
  cfg.policy.critic_hidden_dims = (12,)
  cfg.policy.init_noise_std = 0.8
  a = cfg.algorithm
  a.schedule, a.num_mini_batches, a.num_learning_epochs = 'fixed', 1, 2
  a.learning_rate = 3e-3
  if hasattr(cfg, 'device'):
    cfg.device = 'cpu'
  return cfg


class TorchToyEnv:
  """tests/test_torch_rl.py's deterministic toy env, holding the world's
  rows of its 16 envs."""

  action_dim = ACTION_DIM
  observation_dims = {'policy': POLICY_DIM, 'critic': CRITIC_DIM}
  step_dt = 0.02
  device = torch.device('cpu')

  def __init__(self, world: World):
    self.world = world
    self.num_envs = world.n_local
    self.table = torch.from_numpy(TABLE[:, world.rows])

  def _obs(self, k):
    row = self.table[int(k) % NSTEP_TABLE]
    return {'policy': row[:, :POLICY_DIM],
            'critic': row[:, POLICY_DIM:POLICY_DIM + CRITIC_DIM]}

  def init_state(self, seed=0):
    del seed
    t = torch.arange(N, dtype=torch.int32)[self.world.rows] % 3
    state = {'k': torch.zeros((), dtype=torch.int32), 't': t}
    return state, self._obs(state['k'])

  @property
  def step_fn(self):
    def step(state, action):
      k, t = state['k'], state['t']
      row = self.table[int(k) % NSTEP_TABLE]
      target = row[:, :2]
      reward = (-torch.sum(torch.square(action - target), dim=-1)
                + 0.1 * row[:, POLICY_DIM])
      t = t + 1
      truncated = t >= 3
      terminated = (row[:, -1] > 1.0) & ~truncated
      done = truncated | terminated
      f = lambda x: torch.sum(x).to(torch.float32)
      extras = {
          'time_outs': truncated,
          'reset_count': f(done),
          'episode_length_sum': f(torch.where(done, t, 0)),
          'Episode_Termination/time_out': f(truncated),
          'Episode_Termination/bad': f(terminated),
          'Episode_Reward/r': f(torch.where(done, reward, 0.0))
          / f(done).clamp_min(1.0),
      }
      state = {'k': k + 1, 't': torch.where(done, 0, t)}
      return state, (self._obs(k + 1), reward, terminated, truncated, extras)
    return step


def learner_state(ts) -> dict:
  """The learner of a TrainState as named CPU tensors."""
  c = lambda t: t.detach().clone()
  return {'params': {k: c(p) for k, p in ts.net.named_parameters()},
          'count': c(ts.adam.count),
          'mu': {k: c(v) for k, v in ts.adam.mu.items()},
          'nu': {k: c(v) for k, v in ts.adam.nu.items()},
          'actor_norm': {k: c(v) for k, v in ts.actor_norm.named_buffers()},
          'critic_norm': {k: c(v) for k, v in
                          ts.critic_norm.named_buffers()},
          'lr': c(ts.lr), 'iteration': ts.iteration}


def _iteration(ppo: PPO, ts) -> dict:
  """One learn iteration; what it computed, on the CPU."""
  ts, logs = ppo.learn_iteration(ts)
  logs.pop('_clock')
  traj = ppo.storage
  return {'logs': {k: float(v) for k, v in logs.items()},
          'storage': {k: getattr(traj, k).clone() for k in (
              'actor_obs', 'critic_obs', 'action', 'logprob', 'mean',
              'value', 'reward', 'done', 'time_out')},
          'advantages': ppo.advantages.clone(),
          'returns': ppo.returns.clone(),
          'learner': learner_state(ts), 'gen': ts.gen.get_state()}


def toy(world: World, carried: dict) -> dict:
  """One learn iteration of the toy env from the carried learner and the
  carried env state of all 16 envs, cut to the world's rows by
  enable_sharding."""
  ppo = PPO(TorchToyEnv(world), toy_cfg())
  ts = ppo.init_state()
  with torch.no_grad():
    for t, v in zip(learner_tensors(ts), carried['learner']):
      t.copy_(v)
  ts.iteration = carried['iteration']
  ts.env_state = dict(carried['env_state'])
  ts.obs = dict(carried['obs'])
  enable_sharding(ts, world)
  return _iteration(ppo, ts)


def toy_noise(world: World) -> dict:
  """One learn iteration of the toy env from the port's own seeded
  initial state, with the actions not clipped: the exploration noise of
  every env reaches the env's rewards and the update."""
  cfg = toy_cfg()
  cfg.clip_actions = None
  ppo = PPO(TorchToyEnv(world), cfg)
  return _iteration(ppo, ppo.init_state())


def resume(world: World, out: str) -> dict:
  """Rank 0 saves a Flat-Tiny runner's checkpoint (every rank gathers its
  envs into it), marked as of iteration 5; a runner of another seed on
  every rank then loads its learner, which rank 0 alone reads."""
  from mjlab_torch.rl.runner import OnPolicyRunner
  env = registry.make(FLAT, device='cpu', world=world,
                      **{'scene.num_envs': N})
  rl = registry.load_cfg(FLAT, 'rl_cfg_entry_point')
  rl.device = 'cpu'
  saved = OnPolicyRunner(env, rl)
  saved.ts.iteration = 5
  path = os.path.join(out, 'resume.pt')
  saved.save(path)
  world.barrier()
  rl.seed += 1
  loaded = OnPolicyRunner(env, rl)
  loaded.load(path)
  return {'saved': learner_state(saved.ts), 'loaded': learner_state(
      loaded.ts), 'saved_gen': saved.ts.gen.get_state(),
          'loaded_gen': loaded.ts.gen.get_state()}


def flat_tiny(world: World) -> 'list[dict]':
  """Flat-Tiny, 16 envs in float64, every sampling range a point, env
  FLAT_TIP tipped over before the first env-step: two learn iterations of
  FLAT_STEPS env-steps, one minibatch, two epochs. Actions are clipped to
  0, so that the env's rows do not depend on the network, whose float32
  products round a row differently in a batch of another size."""
  cfg = degenerate_ranges(registry.load_cfg(FLAT), N)
  env = registry.make(FLAT, cfg=cfg, device='cpu', dtype=torch.float64,
                      world=world)
  rl = registry.load_cfg(FLAT, 'rl_cfg_entry_point')
  rl.device = 'cpu'
  rl.num_steps_per_env = FLAT_STEPS
  rl.clip_actions = 0.0
  rl.algorithm.num_mini_batches = 1
  rl.algorithm.num_learning_epochs = 2
  ppo = PPO(env, rl)
  ts = ppo.init_state()
  if FLAT_TIP in range(world.offset, world.offset + world.n_local):
    ts.env_state = tip_over_state(torch, ts.env_state,
                                  FLAT_TIP - world.offset)
  out = []
  for _ in range(2):
    out.append(_iteration(ppo, ts))
    out[-1]['env_gen'] = env.generator.get_state()
  return out


def tracking_tiny(world: World, motion_file: str) -> dict:
  """Tracking-Tiny, 16 envs in float64 on `motion_file`, the registered
  ranges: a reset, TRACK_TIPS tipped over, one env-step of zero actions;
  the command's bin failures and start steps after it."""
  cfg = registry.load_cfg(TRACK)
  cfg.scene.num_envs = N
  cfg.commands.motion.motion_file = motion_file
  env = registry.make(TRACK, cfg=cfg, device='cpu', dtype=torch.float64,
                      world=world)
  state, _ = env.init_state()
  for e in TRACK_TIPS:
    if e in range(world.offset, world.offset + world.n_local):
      state = tip_over_state(torch, state, e - world.offset, 90.0)
  state, (obs, _, terminated, _, _) = env.step_fn(
      state, torch.zeros(env.num_envs, env.action_dim, dtype=torch.float64))
  st = state.command['motion']
  return {k: st[k].clone() for k in ('bin_failed', 'current_bin_failed',
                                     'time_steps')} | {
      'terminated': terminated.clone(), 'obs': obs['policy'].clone()}


def main() -> None:
  job = torch.load(sys.argv[1], weights_only=True)
  out = sys.argv[2]
  torch.set_num_threads(1)
  world = init_world(N, 'cpu', timeout_s=120)
  try:
    res = {}
    if 'toy' in job:
      res['toy'] = toy(world, job['toy'])
    if job.get('toy_noise'):
      res['toy_noise'] = toy_noise(world)
    if job.get('resume'):
      res['resume'] = resume(world, out)
    if job.get('flat_tiny'):
      res['flat_tiny'] = flat_tiny(world)
    if 'tracking_tiny' in job:
      res['tracking_tiny'] = tracking_tiny(world, job['tracking_tiny'])
    res['world'] = (world.rank, world.size, world.backend)
    torch.save(res, os.path.join(out, f'rank{world.rank}.pt'))
  finally:
    close_world(world)


if __name__ == '__main__':
  main()
