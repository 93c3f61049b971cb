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

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import phase_clocks  # noqa: E402  (tools/phase_clocks.py)

PHASES = ('load and warm start', 'residuals and forces',
          'gradient shares, weighted-row list', 'gradient and its norm',
          'Hessian', 'factor and solve', 'linesearch directions',
          'linesearch', 'update', 'final forces')


def main() -> None:
  phase_clocks.start('k2_phase_clocks', '-DK2_PHASE_CLOCKS')
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
  from mjlab_torch.ops import newton as k_newton
  args, (iters, polish, ldof, grad_th) = g1_dropped_inputs(B)
  read = phase_clocks.reader('k2_phase_clocks', k_newton.NAME,
                             'newton_phase_cycles', len(PHASES))

  def run():
    k_newton.newton_solve_cuda(*args, iterations=iters, ls_polish=polish,
                               ldof=ldof, grad_th=grad_th)
    return read()

  run()  # warm-up, table cleared
  phase_clocks.report(
      f'K2 phases, {B} G1 envs, {iters} iterations cap: cycles of thread 0 '
      f'summed over blocks', PHASES, run(), B, 'env')


if __name__ == '__main__':
  main()
