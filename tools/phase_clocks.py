"""Shared reader of the kernels' phase-clock builds (tools/k2_phase_clocks.py,
tools/k3_phase_clocks.py). A kernel source built with its -D...PHASE_CLOCKS
flag makes thread 0 of every block add the clock cycles of each phase to a
global table; its library exports a function that copies the table out and
clears it."""

from __future__ import annotations

import ctypes
import subprocess
import sys


def start(tool: str, flag: str):
  """Checks for a GPU, adds `flag` to the kernel build (a library of its
  own: the name hashes the flags), prints the card, returns torch."""
  import torch
  if not torch.cuda.is_available():
    sys.exit(f'{tool}: needs a GPU')
  from mjlab_torch.ops import _build
  _build.NVCC_FLAGS = _build.NVCC_FLAGS + (flag,)
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  return torch


def reader(tool: str, library: str, function: str, nphases: int):
  """A function that synchronizes, then returns and clears the cycles per
  phase of kernel library `library`."""
  import torch
  from mjlab_torch.ops import _build
  fn = getattr(_build.library(library), function)
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p]
  table = (ctypes.c_ulonglong * nphases)()

  def read():
    torch.cuda.synchronize()
    err = fn(ctypes.addressof(table))
    if err:
      sys.exit(f'{tool}: reading the table failed ({err})')
    return list(table)

  return read


def report(title: str, phases, cycles, per: int, unit: str) -> None:
  total = sum(cycles)
  print(f'{title}; {total / per:.0f} cycles per {unit}', flush=True)
  for name, c in zip(phases, cycles):
    print(f'  {name:36s} {c / per:10.0f} cycles/{unit}  '
          f'{100 * c / total:5.1f} %', flush=True)
