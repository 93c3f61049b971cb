"""What `train.py --shard` costs a training iteration at a world of one.

Builds `Mjlab-Velocity-Flat-Unitree-G1` at N envs on the GPU and one PPO
learner, starts a world of one over NCCL, and runs P pairs of rollouts of
24 env-steps under the learner, the order alternating: one with the env's
and the learner's World the process group's (every collective of a sharded
run: the refresh flag and the normalizers' two merges an env-step), one
with a World without a group (the unsharded code path), on the same env
and learner. Prints each rollout's ms (host clock to a synchronize), the
medians and quartiles of both, the pairs the sharded rollout won, then the
host time and the device time (CUDA events, behind a busy card) of one
all-reduce of each size a sharded iteration makes.

    python3 tools/shard_cost.py [N] [P]   # default 4096 10
"""

from __future__ import annotations

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  import torch

  from mjlab_torch.parallel.sharding import (
      World,
      all_reduce_flat,
      close_world,
      init_world,
  )
  from mjlab_torch.rl.ppo import PPO
  from mjlab_torch.tasks import registry
  args = [int(a) for a in sys.argv[1:]]
  n, pairs = (args + [4096, 10][len(args):])[:2]
  task = 'Mjlab-Velocity-Flat-Unitree-G1'
  sharded = init_world(n, 'cuda')
  plain = World(num_envs=n, device=sharded.device)
  try:
    env = registry.make(task, device=sharded.device, world=sharded,
                        **{'scene.num_envs': n})
    ppo = PPO(env, registry.load_cfg(task, 'rl_cfg_entry_point'))
    ts = ppo.init_state()

    def rollout(world):
      env.world = ppo.world = world
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      ppo._rollout(ts)
      torch.cuda.synchronize()
      return (time.perf_counter() - t0) * 1e3

    rollout(sharded)
    rollout(plain)
    times = {'sharded': [], 'unsharded': []}
    for i in range(pairs):
      order = (('sharded', sharded), ('unsharded', plain))
      for name, world in (order if i % 2 == 0 else order[::-1]):
        times[name].append(rollout(world))
    wins = sum(a < b for a, b in zip(times['sharded'], times['unsharded']))
    for name, ts_ in times.items():
      q = statistics.quantiles(ts_, n=4)
      print(f'{name} rollout of 24 env-steps at {n} envs: '
            f'{[round(t, 1) for t in ts_]} ms; median {statistics.median(ts_):.1f}'
            f', quartiles {q[0]:.1f}-{q[2]:.1f}', flush=True)
    print(f'the sharded rollout was faster in {wins} of {pairs} pairs',
          flush=True)

    # one all-reduce of each size a sharded iteration makes
    dims = ppo.actor_dim + ppo.critic_dim
    n_params = sum(p.numel() for p in ts.net.parameters()) + 5
    busy = torch.zeros((4096, 4096), device=sharded.device)
    for what, size, count in (('refresh flag', 1, 24),
                              ('normalizer merge', dims, 48),
                              ('advantage merge', 1, 2),
                              ('gradients and loss terms', n_params,
                               ppo.cfg.algorithm.num_learning_epochs
                               * ppo.cfg.algorithm.num_mini_batches),
                              ('logs', 24 * 20, 1)):
      x = torch.ones(size, device=sharded.device)
      for _ in range(3):
        all_reduce_flat([x], sharded)
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      for _ in range(100):
        all_reduce_flat([x], sharded)
      host = (time.perf_counter() - t0) * 1e3 / 100
      torch.cuda.synchronize()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      torch.mm(busy, busy)
      start.record()
      for _ in range(100):
        all_reduce_flat([x], sharded)
      end.record()
      end.synchronize()
      dev = start.elapsed_time(end) / 100
      print(f'all-reduce of {size} floats ({what}, {count} an iteration): '
            f'{host:.4f} ms host issue, {dev:.4f} ms on the device behind a '
            f'busy card', flush=True)
    smi = os.popen('nvidia-smi --query-gpu=name,power.limit '
                   '--format=csv,noheader').read().strip()
    print(f'card {smi}', flush=True)
  finally:
    close_world(sharded)


if __name__ == '__main__':
  main()
