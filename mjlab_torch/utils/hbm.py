"""Device-memory fit check: refuse to run what would not fit on the card.

Counterpart of mjlab_tpu/utils/hbm.py, in torch's terms. The JAX guard
reads XLA's memory analysis of a compiled program before it runs; PyTorch
compiles nothing ahead, so the port measures instead: `memory_report`
runs the function once on the card between `reset_peak_memory_stats` and
`max_memory_allocated` and reports the peak beside the card's capacity,
and `assert_fits` raises HbmWouldOverflowError when that peak exceeds a
fraction of the capacity, before a larger run (more envs, a longer
rollout) is started on the same card.

    rep = hbm.memory_report(env.step, action)
    hbm.assert_fits(rep, label='env.step @4096')

Like the JAX module on a backend without memory analysis, all three
functions return None and check nothing on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

# The share of the card's memory one run may claim: the allocator's
# fragmentation, the CUDA context and buffers that the caller keeps alive
# elsewhere are not in the peak
DEFAULT_FRACTION = 0.92


@dataclasses.dataclass
class MemoryReport:
  peak_bytes: int  # the most the caching allocator held while fn ran
  baseline_bytes: int  # what it held when fn was called
  capacity_bytes: 'int | None'

  def __str__(self):
    gb = lambda b: f'{b / 2**30:.2f} GiB'
    cap = gb(self.capacity_bytes) if self.capacity_bytes else 'unknown'
    return (f'peak {gb(self.peak_bytes)} (of it held before the call '
            f'{gb(self.baseline_bytes)}; device capacity {cap})')


def _cuda(device) -> 'torch.device | None':
  if device is None:
    return torch.device('cuda') if torch.cuda.is_available() else None
  device = torch.device(device)
  return device if device.type == 'cuda' else None


def device_capacity(device=None) -> 'int | None':
  """The card's memory in bytes (`torch.cuda.mem_get_info`'s total, else
  the device's `total_memory`); None on the CPU."""
  dev = _cuda(device)
  if dev is None:
    return None
  try:
    return int(torch.cuda.mem_get_info(dev)[1])
  except RuntimeError:
    return int(torch.cuda.get_device_properties(dev).total_memory)


def memory_report(fn, *args, device=None, **kwargs) -> 'MemoryReport | None':
  """Run `fn(*args, **kwargs)` once on the card and report the allocator's
  peak over the call; None (and fn not run) on the CPU."""
  dev = _cuda(device)
  if dev is None:
    return None
  torch.cuda.synchronize(dev)
  torch.cuda.reset_peak_memory_stats(dev)
  baseline = torch.cuda.memory_allocated(dev)
  fn(*args, **kwargs)
  torch.cuda.synchronize(dev)
  return MemoryReport(peak_bytes=int(torch.cuda.max_memory_allocated(dev)),
                      baseline_bytes=int(baseline),
                      capacity_bytes=device_capacity(dev))


class HbmWouldOverflowError(RuntimeError):
  pass


def assert_fits(report: 'MemoryReport | None', label: str = 'program',
                fraction: float = DEFAULT_FRACTION) -> 'MemoryReport | None':
  """Raise HbmWouldOverflowError when the report's peak exceeds `fraction`
  of the card's capacity. Returns the report; None (nothing checked) on
  the CPU or where the capacity is unknown."""
  if report is None or not report.capacity_bytes:
    return report
  budget = int(report.capacity_bytes * fraction)
  if report.peak_bytes > budget:
    raise HbmWouldOverflowError(
        f'{label}: peak device memory {report.peak_bytes / 2**30:.2f} GiB '
        f'exceeds {fraction:.0%} of device capacity '
        f'{report.capacity_bytes / 2**30:.2f} GiB; refusing to execute '
        f'(shrink the batch or shard over more cards). {report}')
  return report
