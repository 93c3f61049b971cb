"""Where the host spends an env-step of the PyTorch port on the GPU.

Builds `Mjlab-Velocity-Flat-Unitree-G1` at the given width on the card,
warms it up under the shipped actor, then
  1. prints the stack of every synchronizing call of one env-step
     (`torch.cuda.set_sync_debug_mode('warn')`),
  2. runs a few env-steps under cProfile and prints the functions by their
     own and by cumulative host time,
  3. runs a few env-steps under torch.profiler and prints the CUDA kernels
     and the host ops by total time, and the share of the window in which
     the device was busy.

    python3 tools/env_step_profile.py [num_envs] [steps]

Needs one NVIDIA GPU and the CUDA toolkit (the kernels are built on first
use). Prints the card's name and power limit first.
"""
from __future__ import annotations

import cProfile
import os
import pstats
import subprocess
import sys
import time
import traceback
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(num_envs: int = 4096, steps: int = 5) -> None:
  import torch
  if not torch.cuda.is_available():
    sys.exit('env_step_profile: needs an NVIDIA GPU')
  from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.tasks import registry
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  env = registry.make('Mjlab-Velocity-Flat-Unitree-G1',
                      **{'scene.num_envs': num_envs})
  actor = load_actor(G1_FLAT_POLICY)
  obs, _ = env.reset()
  for _ in range(3):
    obs, *_ = env.step(actor(obs))

  def run(n):
    nonlocal obs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
      obs, *_ = env.step(actor(obs))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3

  plain_ms = run(steps)
  print(f'{num_envs} envs: {plain_ms:.2f} ms an env-step, unprofiled',
        flush=True)

  # 1. who waits for the card
  def show(message, category, filename, lineno, file=None, line=None):
    if 'synchroniz' in str(message):
      frames = [f for f in traceback.extract_stack()[:-1]
                if 'mjlab_torch' in f.filename]
      print('sync at: ' + ' <- '.join(
          f'{os.path.basename(f.filename)}:{f.lineno} {f.name}'
          for f in reversed(frames[-4:])), flush=True)

  act = actor(obs)
  torch.cuda.set_sync_debug_mode('warn')
  old = warnings.showwarning
  warnings.showwarning = show
  try:
    with warnings.catch_warnings():
      warnings.simplefilter('always')
      warnings.showwarning = show
      env.step(act)
  finally:
    warnings.showwarning = old
    torch.cuda.set_sync_debug_mode('default')

  # 2. the host's functions
  prof = cProfile.Profile()
  prof.enable()
  ms = run(steps)
  prof.disable()
  print(f'under cProfile: {ms:.2f} ms an env-step', flush=True)
  for key in ('tottime', 'cumulative'):
    stats = pstats.Stats(prof, stream=sys.stdout)
    stats.strip_dirs().sort_stats(key).print_stats(22)

  # 3. the device's kernels
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
    ms = run(steps)
  print(f'under torch.profiler: {ms:.2f} ms an env-step', flush=True)
  avg = tp.key_averages()
  print(avg.table(sort_by='cuda_time_total', row_limit=15), flush=True)
  print(avg.table(sort_by='self_cpu_time_total', row_limit=15), flush=True)
  # kernels only: a host op's row repeats the time of the kernels it launched
  busy_us = sum(e.self_device_time_total for e in avg
                if e.device_type == torch.autograd.DeviceType.CUDA)
  busy_ms = busy_us / 1e3 / steps
  print(f'device busy {busy_ms:.2f} ms an env-step: {busy_ms / plain_ms:.3f} '
        f'of the unprofiled {plain_ms:.2f} ms, {busy_ms / ms:.3f} of the '
        f'profiled {ms:.2f} ms', flush=True)


if __name__ == '__main__':
  main(*(int(a) for a in sys.argv[1:3]))
