"""K1's plain version: batched small SPD solve H x = g (frozen copy)."""

from __future__ import annotations

import torch

from mjref.physics import linalg as _linalg


def solve_pd(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
  """Solve H x = g for SPD H (B, n, n) and g (B, n)."""
  return _linalg.solve_pd(H, g)
