"""What the NaN guard and the blowup ring cost a G1 flat env-step.

Builds `Mjlab-Velocity-Flat-Unitree-G1` twice at N envs on the GPU, once
plain and once with `MJLAB_BLOWUP_DUMP` set and its step wrapped in a
NanGuard, and times S env-steps under zero actions of each in P pairs,
the order alternating (off-on, on-off, ...). Prints each run's ms an
env-step, the medians and quartiles of both, the pairs the guarded env
won, and the host time of the ring's write (`_forensic_write`, issue
only) and the kernel launches of one env-step of each, counted by
torch.profiler.

    python3 tools/nan_guard_cost.py [N] [S] [P]   # default 4096 20 10
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  import torch
  args = [int(a) for a in sys.argv[1:]]
  n, steps, pairs = (args + [4096, 20, 10][len(args):])[:3]
  if not torch.cuda.is_available():
    raise SystemExit('needs a GPU')
  torch.backends.cuda.matmul.allow_tf32 = False
  card = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  print(card, flush=True)

  from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnv
  from mjlab_torch.ops import build_all
  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.nan_guard import NanGuard
  build_all()
  task = 'Mjlab-Velocity-Flat-Unitree-G1'
  root = tempfile.mkdtemp(prefix='nan_guard_cost_')

  def env_of(on: bool):
    if on:
      os.environ['MJLAB_BLOWUP_DUMP'] = os.path.join(root, 'ring')
    try:
      env = registry.make(task, **{'scene.num_envs': n})
    finally:
      os.environ.pop('MJLAB_BLOWUP_DUMP', None)
    step = env.step_fn
    if on:
      step = NanGuard(env, out_dir=os.path.join(root, 'dumps')).wrap(step)
    return env, step, [env.init_state()[0]]

  runs = {'off': env_of(False), 'on': env_of(True)}
  zero = torch.zeros(n, runs['off'][0].action_dim, device='cuda')

  def timed(what, k=steps):
    _, step, box = runs[what]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(k):
      box[0], _ = step(box[0], zero)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / k

  for what in runs:
    timed(what, 3)
  ms = {'off': [], 'on': []}
  wins = 0
  for p in range(pairs):
    order = ('off', 'on') if p % 2 == 0 else ('on', 'off')
    got = {w: timed(w) for w in order}
    for w in order:
      ms[w].append(got[w])
    wins += got['on'] < got['off']
    print(f'pair {p}: ' + ', '.join(f'{w} {got[w]:.3f}' for w in order)
          + ' ms an env-step', flush=True)
  for w, v in ms.items():
    q = statistics.quantiles(v, n=4)
    print(f'{w}: median {statistics.median(v):.3f} ms, quartiles {q[0]:.3f}'
          f' - {q[2]:.3f} ms over {pairs} runs of {steps} env-steps',
          flush=True)
  print(f'the guarded env was faster in {wins} of {pairs} pairs; {n} envs; '
        f'card {card}', flush=True)

  # the ring's write: host time to issue it (no wait for the device)
  plain_write = ManagerBasedRlEnv._forensic_write
  issue = []

  def write(self, *a, **kw):
    t0 = time.perf_counter()
    out = plain_write(self, *a, **kw)
    issue.append(time.perf_counter() - t0)
    return out

  ManagerBasedRlEnv._forensic_write = write
  try:
    timed('on')
  finally:
    ManagerBasedRlEnv._forensic_write = plain_write
  print(f'_forensic_write: {statistics.median(issue) * 1e3:.3f} ms of host '
        f'issue a call (median of {len(issue)})', flush=True)

  # kernels launched in one env-step of each
  from torch.profiler import ProfilerActivity, profile
  for what in runs:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      timed(what, 1)
    dev_us = lambda e: getattr(e, 'self_device_time_total',
                               getattr(e, 'self_cuda_time_total', 0))
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith('CUDA')]
    print(f'{what}: {sum(e.count for e in kernels)} device events in one '
          f'env-step, {sum(dev_us(e) for e in kernels) / 1e3:.3f} ms of '
          f'device time', flush=True)


if __name__ == '__main__':
  main()
