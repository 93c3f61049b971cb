#!/usr/bin/env python3
"""Where the K2 Newton kernel (mjlab_torch/csrc/newton.cu) spends its
cycles, phase by phase, on one NVIDIA GPU.

Builds newton.cu with -DK2_PHASE_CLOCKS, which makes thread 0 of every
block add the clock cycles of each phase to a global table, runs the kernel
on 4096 Unitree G1 flat envs dropped onto the floor (the input of
chip_smoke.py's phase 2c), and prints each phase's share of the summed
block time. The instrumented build is slower than the shipped one; read the
shares, not the total. With as many envs as the card has SMs (132 on an
H100) every block has its SM to itself, and the cycles are the phases' bare
latencies; at 4096 envs they include the wait for the SM's other blocks.
Run from the repository root:

    python3 tools/k2_phase_clocks.py [ENVS ...]     (default: 4096)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ('load and warm start', 'residuals and forces',
          'gradient shares, weighted-row list', 'gradient and its norm',
          'Hessian', 'factor and solve', 'linesearch directions',
          'linesearch', 'update', 'final forces')


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    sys.exit('k2_phase_clocks: needs a GPU')
  from mjlab_torch.ops import _build
  _build.NVCC_FLAGS = _build.NVCC_FLAGS + ('-DK2_PHASE_CLOCKS',)
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  for envs in [int(a) for a in sys.argv[1:]] or [4096]:
    profile(envs)


def g1_dropped_inputs(B: int):
  """K2's arguments for B G1 flat envs dropped 3 cm into the floor, from
  chip_smoke.py's own helper and seed (at B = 4096 the very input of its
  phase 2c), and (iterations, ls_polish, ldof, grad_th)."""
  import torch
  import chip_smoke
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import g1_flat_arrays
  from mjlab_torch.physics import solver
  mj = g1_flat_arrays()
  m = phys.put_model(mj)
  gen = torch.Generator().manual_seed(0)
  chip_smoke.g1_states(torch, phys, mj, m, B, 0.0, gen)  # phase 2a's draw
  args, _ = chip_smoke.k2_dropped_input(torch, phys, mj, m, B, gen)
  return args, solver.solver_params(m.stat)


def profile(B: int) -> None:
  import torch
  from mjlab_torch.ops import _build
  from mjlab_torch.ops import newton as k_newton
  args, (iters, polish, ldof, grad_th) = g1_dropped_inputs(B)

  fn = _build.library(k_newton.NAME).newton_phase_cycles
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p]
  table = (ctypes.c_ulonglong * len(PHASES))()

  def run():
    k_newton.newton_solve_cuda(*args, iterations=iters, ls_polish=polish,
                               ldof=ldof, grad_th=grad_th)
    torch.cuda.synchronize()
    err = fn(ctypes.addressof(table))
    if err:
      sys.exit(f'k2_phase_clocks: reading the table failed ({err})')
    return list(table)

  run()  # warm-up, table cleared
  cycles = run()
  total = sum(cycles)
  print(f'K2 phases, {B} G1 envs, {iters} iterations cap: cycles of thread '
        f'0 summed over blocks; {total / B:.0f} cycles per env', flush=True)
  for name, c in zip(PHASES, cycles):
    print(f'  {name:36s} {c / B:10.0f} cycles/env  {100 * c / total:5.1f} %',
          flush=True)


if __name__ == '__main__':
  main()
