#!/usr/bin/env python3
"""The K3 fused smooth kernel (mjlab_torch/csrc/smooth.cu) on one NVIDIA
GPU: where its cycles go, phase by phase, and what each launch shape and
the wrapper's host path cost.

1. Builds smooth.cu with -DK3_PHASE_CLOCKS, which makes thread 0 of every
   block add the clock cycles of each phase to a global table, runs the
   kernel on Unitree G1 flat envs (the states of chip_smoke.py's phase 2a)
   and prints each phase's share of the summed time of the blocks' first
   warps. The instrumented build is slower than the shipped one; read the
   shares. With as many envs as one block an SM holds, the cycles are the
   phases' bare latencies; at 4096 envs they include the wait for the SM's
   other warps.
2. With --shapes, on the shipped build: the kernel's time behind a busy
   card (chip_smoke.py's device timer) for 1 to 16 envs a block, and the
   host's time for one wrapper call, made without waiting for the card,
   with the profiler's account of it.
Run from the repository root:

    python3 tools/k3_phase_clocks.py [--shapes] [ENVS ...]   (default: 4096)
"""

from __future__ import annotations

import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import phase_clocks  # noqa: E402  (tools/phase_clocks.py)

PHASES = ('load', 'joint locals', 'kinematic sweep', 'frames',
          'subtree COM', 'cinr and cdof', 'cvel, cdof_dot, cacc',
          'RNE body forces', 'backward sweep', 'mass matrix and bias')


def g1_inputs(B: int):
  """The model and B G1 flat states, from chip_smoke.py's own helper and
  seed (at B = 4096 the very input of its phase 2a)."""
  import torch
  import chip_smoke
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import g1_flat_arrays
  mj = g1_flat_arrays()
  m = phys.put_model(mj)
  gen = torch.Generator().manual_seed(0)
  return m, chip_smoke.g1_states(torch, phys, mj, m, B, 0.0, gen)


def profile(B: int) -> None:
  from mjlab_torch.ops import smooth_kernel as k_smooth
  m, d = g1_inputs(B)
  read = phase_clocks.reader('k3_phase_clocks', k_smooth.NAME,
                             'smooth_phase_cycles', len(PHASES))

  def run():
    k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel,
                               envs_per_block=k_smooth.ENVS_PER_BLOCK)
    return read()

  run()  # warm-up, table cleared
  epb = k_smooth.ENVS_PER_BLOCK
  blocks = -(-B // epb)
  phase_clocks.report(
      f'K3 phases, {B} G1 envs, {epb} envs a block: cycles of thread 0 '
      f'summed over {blocks} blocks', PHASES, run(), blocks, 'block')


def shapes(torch, B: int) -> None:
  import chip_smoke
  from mjlab_torch.ops import smooth_kernel as k_smooth
  m, d = g1_inputs(B)
  busy = torch.zeros((4096, 4096), device='cuda')
  print(f'K3 launch shapes, {B} G1 envs: ms behind a busy card (median of '
        f'20); bytes of shared memory a block', flush=True)
  for epb in (1, 2, 4, 6, 8, 12, 16):
    fn = lambda: k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel,
                                            envs_per_block=epb)
    ms = chip_smoke.time_ms(torch, fn, 20, busy=busy)
    print(f'  {epb:2d} envs a block: {ms:.4f} ms, '
          f'{k_smooth.smooth_smem_bytes(m, epb)} B', flush=True)
  # the host's path: calls made back to back, the card never waited for
  fn = lambda: k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel)
  for _ in range(20):
    fn()
  torch.cuda.synchronize()
  n = 500
  t0 = time.perf_counter()
  for _ in range(n):
    fn()
  host = (time.perf_counter() - t0) / n * 1e3
  torch.cuda.synchronize()
  print(f'K3 wrapper, host time a call ({n} calls, no wait for the card): '
        f'{host:.4f} ms', flush=True)
  import cProfile
  import pstats
  prof = cProfile.Profile()
  prof.enable()
  for _ in range(n):
    fn()
  prof.disable()
  torch.cuda.synchronize()
  pstats.Stats(prof).sort_stats('tottime').print_stats(8)


def main() -> None:
  args = sys.argv[1:]
  sweep = '--shapes' in args
  envs = [int(a) for a in args if a != '--shapes'] or [4096]
  if sweep:
    import torch
    if not torch.cuda.is_available():
      sys.exit('k3_phase_clocks: needs a GPU')
    for B in envs:
      shapes(torch, B)
    return
  phase_clocks.start('k3_phase_clocks', '-DK3_PHASE_CLOCKS')
  for B in envs:
    profile(B)


if __name__ == '__main__':
  main()
