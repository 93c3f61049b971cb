"""What the per-layer metric files share: the reading of the traced run's
record (benchmark/lib/trace.py). Each function returns None where the
record holds nothing to read (a range that never ran, an entry the port
no longer has, no matched kernel), and the harness then leaves the metric
out. No share of a roofline or a peak is ever made up as 0.
"""

from __future__ import annotations

import statistics

from benchmark.lib import work

# the port's entry functions that the metric files put ranges around
COLLISION = {'entry.collision': 'mjlab_torch.physics.collision:collision'}
SOLVE = {'entry.solve': 'mjlab_torch.physics.solver:solve'}
SMOOTH = {'entry.smooth': 'mjlab_torch.ops.smooth_kernel:smooth_fused_cuda'}
NEWTON = {'entry.newton': 'mjlab_torch.ops.newton:newton_solve_cuda'}
PD_SOLVE = {'entry.pd_solve': 'mjlab_torch.ops.pd_solve:solve_pd_cuda'}


def _ops_of(rec: dict, rng: str, kernels_only: bool = False) -> list:
  return [o for o in rec['ops'] if rng in o[3]
          and (not kernels_only or o[4] == 'kernel')]


def device_ms_per_step(rec: dict, rng: str):
  """Device time of the operations launched inside range `rng`, per
  env-step of the window, in ms."""
  ops = _ops_of(rec, rng)
  if not ops or not rec.get('steps'):
    return None
  return sum(o[2] for o in ops) * 1e-3 / rec['steps']


def launches_per_step(rec: dict, rng: str = 'bench.env_step'):
  """Device kernels launched inside range `rng` per env-step."""
  ops = _ops_of(rec, rng, kernels_only=True)
  if not ops or not rec.get('steps'):
    return None
  return len(ops) / rec['steps']


def device_idle_pct(rec: dict):
  """Share of the profiled window in which no device operation ran, %."""
  if not rec.get('window_s') or not rec.get('busy_s'):
    return None
  return 100.0 * (1.0 - rec['busy_s'] / rec['window_s'])


def first_call_s(rec: dict, rng: str):
  """Device seconds of the operations launched by the first call of range
  `rng` (the call whose inputs a capture holds)."""
  calls = rec['ranges'].get(rng)
  if not calls:
    return None
  s, d = calls[0]
  ops = [o for o in rec['ops'] if o[5] is not None and s <= o[5] <= s + d]
  if not ops:
    return None
  return sum(o[2] for o in ops) * 1e-6


def roofline_pct(rec: dict, rng: str, call_work):
  """The least time of the captured first call's work over the device time
  of that call's operations, %. `call_work(args, kwargs, result)` gives
  (bytes, FLOPs)."""
  cap = rec['captures'].get(rng)
  t = first_call_s(rec, rng)
  if cap is None or not t:
    return None
  nbytes, flops = call_work(*cap)
  return 100.0 * work.least_s(nbytes, flops, rec.get('kind')) / t


def k3_work(args, kwargs, res):
  m, qpos, qvel = args[:3]
  return work.k3_call(m, qpos, qvel, res)


def k2_work(args, kwargs, res):
  return work.k2_call(args, kwargs)


def k1_work(args, kwargs, res):
  H = args[0]
  return work.k1_call(H.shape[0], H.shape[-1])


def step_flops(rec: dict):
  """FLOPs of the profiled window's algorithm: each kernel's calls at the
  work of its captured call, the actor's (and in training the critic's)
  products over the window's env-steps, and the update's forward and
  backward passes (three forward passes' worth) over its epochs."""
  total = 0
  for rng, fn in (('entry.smooth', k3_work), ('entry.newton', k2_work),
                  ('entry.pd_solve', k1_work)):
    calls = rec['ranges'].get(rng, [])
    cap = rec['captures'].get(rng)
    if calls and cap is None:
      return None
    if calls:
      total += len(calls) * fn(*cap)[1]
  mlp = rec.get('mlp') or {}
  n, steps = rec['num_envs'], rec['steps']
  nets = [d for d in mlp.values()]
  per_row = sum(work.mlp_flops(d, 1) for d in nets)
  total += steps * n * per_row
  if 'critic' in mlp:
    total += n * work.mlp_flops(mlp['critic'], 1)  # the bootstrap value
  total += rec.get('update_passes', 0) * 3 * steps * n * per_row
  return total


def mfu_pct(rec: dict):
  """The window's FLOPs over the window's time at the card's float32
  peak, %."""
  if not rec.get('busy_s'):
    return None
  flops = step_flops(rec)
  if not flops or not rec.get('window_s'):
    return None
  return 100.0 * flops / (rec['window_s'] * work.peak(rec.get('kind'))[
      'f32_flops'])


def clock_mean_ms(rec: dict, key: str):
  """Mean of the StageClock's `key` over the window's iterations."""
  vals = [c[key] for c in rec.get('clock') or [] if key in c]
  return statistics.fmean(vals) if vals else None
