"""K1: batched small SPD solve H x = g.

Hand-written CUDA kernel (csrc/pd_solve.cu) in place of the TPU kernel
mjlab_tpu/ops/pd_solve.py:_pd_solve_kernel. Its plain version is
physics/linalg.py:solve_pd, the same column Cholesky written in torch.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel (float32, any n) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from mjlab_torch.ops import _build
from mjlab_torch.physics import linalg as _linalg

NAME = 'pd_solve'


def solve_pd_cuda(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Kernel path: H (B, n, n), g (B, n), float32 CUDA -> x (B, n)."""
  B, n = g.shape
  _build.require(H, 'H', (B, n, n))
  _build.require(g, 'g', (B, n))
  lib = _build.library(NAME)
  fn = lib.pd_solve_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
      ctypes.c_void_p]
  x = torch.empty_like(g)
  L = torch.empty((n * (n + 1) // 2, B), dtype=H.dtype, device=H.device)
  err = fn(H.data_ptr(), g.data_ptr(), x.data_ptr(), L.data_ptr(), B, n,
           _build.stream_ptr(H))
  _build.check(lib, NAME, err)
  _build.LAUNCHES[NAME] += 1
  return x


def solve_pd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Solve H x = g for SPD H (B, n, n) and g (B, n)."""
  if H.device.type == 'cpu':
    return _linalg.solve_pd(H, g)
  return solve_pd_cuda(H.contiguous(), g.contiguous())
