"""K1: batched small SPD solve H x = g.

Hand-written CUDA kernel (csrc/pd_solve.cu) in place of the TPU kernel
mjlab_tpu/ops/pd_solve.py:_pd_solve_kernel. Its plain version is
physics/linalg.py:solve_pd, the same column Cholesky written in torch.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel (float32) or raises. The kernel gives one warp to each
env and keeps that env's factor in shared memory, so it takes any n up to
`max_n()` (335: the padded triangle of H plus g within the 232,448 bytes a
Hopper block may use; the repo's models have nv <= 35) and raises above it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mjlab_torch.ops import _build
from mjlab_torch.physics import linalg as _linalg

NAME = 'pd_solve'


@functools.cache
def max_n() -> int:
  """Largest system size the kernel takes, as the library reports it for
  `_build.SMEM_LIMIT` (builds the library on first use)."""
  fn = _build.library(NAME).pd_solve_max_n
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_size_t]
  return int(fn(_build.SMEM_LIMIT))


def solve_pd_cuda(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Kernel path: H (B, n, n), g (B, n), float32 CUDA -> x (B, n). Raises
  ValueError for n above `max_n()`."""
  B, n = g.shape
  _build.require(H, 'H', (B, n, n))
  _build.require(g, 'g', (B, n))
  if n > max_n():
    raise ValueError(
        f'pd_solve kernel takes n <= {max_n()} (one env\'s factor within '
        f'the {_build.SMEM_LIMIT} bytes of shared memory a block may use), '
        f'got n = {n}')
  lib = _build.library(NAME)
  fn = lib.pd_solve_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
      ctypes.c_size_t, ctypes.c_void_p]
  x = torch.empty_like(g)
  err = fn(H.data_ptr(), g.data_ptr(), x.data_ptr(), B, n,
           _build.SMEM_LIMIT, _build.stream_ptr(H))
  _build.check(lib, NAME, err)
  _build.LAUNCHES[NAME] += 1
  return x


def solve_pd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Solve H x = g for SPD H (B, n, n) and g (B, n)."""
  if H.device.type == 'cpu':
    return _linalg.solve_pd(H, g)
  return solve_pd_cuda(H.contiguous(), g.contiguous())
