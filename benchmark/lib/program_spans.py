"""What the per-layer metrics that read the port's own spans and counters
share (mjlab_torch/utils/tracing.py): the device time launched inside each
physics stage span, the idle device time while the host is inside a
physics span, and the counters the port kept while the traced window was
profiled. Each returns None where there is nothing to read (a span the
program never opened, as in a program without spans; no device operation,
as on the CPU; no counter), and the harness then leaves the metric out.
"""

from __future__ import annotations

from benchmark.lib import readers, trace

PHYSICS = 'physics.'


def stage_ms(rec: dict, stage: str):
  """Device time per env-step of the operations launched inside the span
  physics.<stage>, in ms."""
  return readers.device_ms_per_step(rec, PHYSICS + stage)


def physics_idle_ms(rec: dict):
  """Idle device time per env-step, in ms, over the gaps of the window
  whose midpoint lies inside a physics.* span (the host issuing a physics
  stage while the device waits)."""
  if not rec.get('busy_s') or not rec.get('steps'):
    return None
  spans = [iv for name, iv in rec['ranges'].items()
           if name.startswith(PHYSICS)]
  if not spans:
    return None
  idle = sum(e - s for s, e in trace.idle_gaps(rec)
             if any(trace._inside(iv, 0.5 * (s + e)) for iv in spans))
  return idle * 1e-3 / rec['steps']


def counters(rec: dict) -> dict:
  """{name: (sum, elements, calls)} of the port's counters in the traced
  window, kept in the record as `counters`. The first reader of a record
  that trace.profile made (it has `host_window_s`) takes them from the port
  and clears the port's store; any other record has none of its own."""
  if 'counters' not in rec:
    rec['counters'] = _take() if 'host_window_s' in rec else {}
  return rec['counters']


def _take() -> dict:
  try:
    from mjlab_torch.utils import tracing
  except ImportError:  # a program without counters
    return {}
  got = tracing.counters()
  tracing.reset_counters()
  return got


def contacts_per_env(rec: dict):
  """Mean active contacts of an env at a collision call."""
  c = counters(rec).get('contacts_active')
  return c[0] / c[1] if c and c[1] else None


def resets_per_step(rec: dict):
  """Mean envs reset at an env-step."""
  c = counters(rec).get('resets')
  return c[0] / c[2] if c and c[2] else None
