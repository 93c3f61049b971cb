"""Static model tables (numpy, host side) as tensors, uploaded once per
device and dtype. A fresh host-to-device copy of an index table on every
call would wait for the device each time; the engine's per-substep code
takes its gather indices and masks from here instead. Callers must not
write into the returned tensors."""

from __future__ import annotations

import numpy as np
import torch

_cache: dict = {}


def table(a, dtype: torch.dtype, device) -> torch.Tensor:
  a = np.ascontiguousarray(a)
  key = (a.tobytes(), a.shape, a.dtype.str, dtype, str(device))
  t = _cache.get(key)
  if t is None:
    t = torch.as_tensor(a, device=device).to(dtype)
    _cache[key] = t
  return t


def ix(a, device) -> torch.Tensor:
  """An int64 index tensor of a static table."""
  return table(a, torch.long, device)


def mask(a, like: torch.Tensor) -> torch.Tensor:
  """A static table in the dtype and on the device of `like`."""
  return table(a, like.dtype, like.device)
