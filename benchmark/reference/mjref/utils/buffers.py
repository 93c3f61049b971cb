"""Circular buffer for observation history, as state plus pure functions.

Counterpart of mjlab_tpu/utils/buffers.py. Per-env reset; the first frame
appended after a reset fills the whole history; `lag` reads newest first.
No function writes into its argument.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CircularBuffer:
  buf: torch.Tensor  # (num_envs, max_len, dim)
  ptr: torch.Tensor  # (num_envs,) int64: index of the most recent write
  count: torch.Tensor  # (num_envs,) int64: appends since the last reset

  def replace(self, **kwargs) -> 'CircularBuffer':
    return dataclasses.replace(self, **kwargs)


def create(num_envs: int, max_len: int, dim: int, dtype=torch.float32,
           device='cpu') -> CircularBuffer:
  return CircularBuffer(
      buf=torch.zeros((num_envs, max_len, dim), dtype=dtype, device=device),
      ptr=torch.zeros(num_envs, dtype=torch.long, device=device),
      count=torch.zeros(num_envs, dtype=torch.long, device=device))


def reset(cb: CircularBuffer, mask: torch.Tensor) -> CircularBuffer:
  """Reset the envs where mask is True."""
  zero = torch.zeros_like(cb.ptr)
  return cb.replace(ptr=torch.where(mask, zero, cb.ptr),
                    count=torch.where(mask, zero, cb.count))


def append(cb: CircularBuffer, value: torch.Tensor) -> CircularBuffer:
  """Append one frame (num_envs, dim); backfills on the first append."""
  max_len = cb.buf.shape[1]
  first = cb.count == 0
  new_ptr = torch.where(first, torch.zeros_like(cb.ptr),
                        (cb.ptr + 1) % max_len)
  filled = torch.where(first[:, None, None],
                       value[:, None, :].expand_as(cb.buf), cb.buf)
  index = new_ptr[:, None, None].expand(-1, 1, value.shape[-1])
  buf = filled.scatter(1, index, value[:, None, :])
  return cb.replace(buf=buf, ptr=new_ptr, count=cb.count + 1)


def _rows(cb: CircularBuffer, idx: torch.Tensor) -> torch.Tensor:
  """buf[e, idx[e, j]] for every env e."""
  return cb.buf.gather(
      1, idx[..., None].expand(-1, -1, cb.buf.shape[-1]))


def all_frames(cb: CircularBuffer) -> torch.Tensor:
  """(num_envs, max_len, dim), ordered oldest -> newest."""
  max_len = cb.buf.shape[1]
  steps = torch.arange(max_len, device=cb.ptr.device)
  return _rows(cb, (cb.ptr[:, None] + 1 + steps[None, :]) % max_len)


def lag(cb: CircularBuffer, lags: torch.Tensor) -> torch.Tensor:
  """(num_envs, dim): the frame `lags[e]` appends ago; 0 is the newest."""
  max_len = cb.buf.shape[1]
  return _rows(cb, ((cb.ptr - lags) % max_len)[:, None])[:, 0]
