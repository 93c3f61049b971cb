"""Small dense SPD solves, column by column.

Counterpart of mjlab_tpu/physics/linalg.py and the plain version of kernel
K1 (ops/pd_solve.py): the same column Cholesky with the pivot clamped to
max(col_jj, 1e-12), then forward and back substitution, written over a
leading batch axis. No library solver stands in for it, so its numerics
(the clamp, the order of the sums) are the kernel's.
"""

from __future__ import annotations

import torch


def cholesky(a: torch.Tensor) -> torch.Tensor:
  """Lower Cholesky factor of SPD matrices a: (..., n, n)."""
  n = a.shape[-1]
  L = torch.zeros_like(a)
  for j in range(n):
    row = L[..., j, :].clone()  # columns < j are filled, the rest zero
    d = torch.sqrt((a[..., j, j] - (row * row).sum(-1)).clamp_min(1e-12))
    L[..., j, j] = d
    if j + 1 < n:
      below = a[..., j + 1:, j] - torch.einsum(
          '...ik,...k->...i', L[..., j + 1:, :], row)
      L[..., j + 1:, j] = below / d[..., None]
  return L


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L x = b, L lower triangular (forward substitution)."""
  n = L.shape[-1]
  x = torch.zeros_like(b)
  for i in range(n):
    x[..., i] = (b[..., i] - (L[..., i, :] * x).sum(-1)) / L[..., i, i]
  return x


def solve_upper_t(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve L^T x = b with the lower factor L (back substitution)."""
  n = L.shape[-1]
  x = torch.zeros_like(b)
  for i in range(n - 1, -1, -1):
    x[..., i] = (b[..., i] - (L[..., :, i] * x).sum(-1)) / L[..., i, i]
  return x


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b given the lower Cholesky factor L of A."""
  return solve_upper_t(L, solve_lower(L, b))


def solve_pd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve SPD systems a x = b: a (..., n, n), b (..., n)."""
  return cho_solve(cholesky(a), b)
