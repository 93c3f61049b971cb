"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes a step's algorithm needs, from frozen functions only.

The kernels' work comes from the frozen copy of the port's `ops/work.py`
(benchmark/reference/mjref/ops/work.py): K3's from the model's sizes, K2's
with its Newton steps counted by the frozen plain Newton on the call's own
inputs, K1's from the system size. The actor's and critic's products come
from their widths. Nothing here reads the program's op counters.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense, at 700 W.
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'f32_flops': 67e12, 'hbm_bytes': 3.35e12},
}
DEFAULT_PEAK = PEAKS['NVIDIA H100 80GB HBM3']


def peak(kind: 'str | None') -> dict:
  return PEAKS.get(kind or '', DEFAULT_PEAK)


def least_s(nbytes: float, flops: float, kind: 'str | None' = None) -> float:
  """The least time the card could take: the larger of the bytes over its
  memory rate and the operations over its float32 rate."""
  p = peak(kind)
  return max(nbytes / p['hbm_bytes'], flops / p['f32_flops'])


def mlp_flops(dims: list, rows: int) -> int:
  """Multiply-adds of one forward pass of dense layers `dims` [(in, out)]
  over `rows` rows, at 2 FLOPs each, the bias adds included."""
  return rows * sum(2 * i * o + o for i, o in dims)


def k3_call(m, qpos, qvel, outs: dict) -> 'tuple[int, int]':
  """(bytes, FLOPs) of one K3 call (frozen ops/work.py:k3_work)."""
  from mjref.ops import work
  return work.k3_work(m, qpos, qvel, outs)


def k2_call(args: tuple, kwargs: dict) -> 'tuple[int, int]':
  """(bytes, FLOPs) of one K2 call on its own inputs, the Newton steps
  counted by the frozen plain Newton (frozen ops/work.py:newton_work)."""
  from mjref.ops import work
  out = work.newton_work(tuple(args), kwargs['iterations'],
                         kwargs['ls_polish'], tuple(kwargs['ldof']),
                         kwargs['grad_th'])
  return out[3], out[4]


def k1_call(batch: int, n: int) -> 'tuple[int, int]':
  """(bytes, FLOPs) of one K1 call: B systems of size n."""
  from mjref.ops import work
  return 4 * batch * (n * n + 2 * n), batch * work.chol_solve_flops(n)
