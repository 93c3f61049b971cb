"""The traced run: profiler ranges around the port's entry functions that
the cell's metrics name, a torch.profiler window, and the record that the
per-layer readers read.

A metric file may declare `ENTRIES = {range: 'module:function'}`: in the
traced run only, that function of the port is wrapped in a
`torch.profiler.record_function(range)`, so that device operations can be
matched to it through the profiler's launch correlation (a kernel belongs
to every range whose host interval holds the runtime or driver call that
launched it). `CAPTURE = [range, ...]` also keeps a copy of the first
call's arguments and result in the record, for readers that count the
work of a call. A renamed entry is no error: its metric reads null.

The record (a dict):
  window: (start, end) of the profiled window on the trace's clock, us
  window_s, busy_s: its length, and the union of device operations in it
  steps: env-steps in the window (per-step metrics divide by it)
  ops: device operations [(name, start_us, dur_us, ranges, category,
       launch_us)], `ranges` the names of the ranges that launched it
  ranges: {name: [(start_us, dur_us)]} of every profiler range
  captures: {range: (args, kwargs, result)} of the first captured call
  plus what the driver adds (`mlp`, `update_passes`, `clock`, `num_envs`,
  `model`).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import gzip
import importlib
import json
import os
import tempfile
import time

import torch

from benchmark.lib import tree

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


def resolve(target: str):
  """(module, attribute name) of 'pkg.module:function', or None."""
  mod_name, _, attr = target.partition(':')
  try:
    mod = importlib.import_module(mod_name)
  except ImportError:
    return None
  return (mod, attr) if callable(getattr(mod, attr, None)) else None


@contextlib.contextmanager
def wrapped_entries(entries: dict, capture: set, captures: dict):
  """Each `range: 'module:function'` of `entries` wrapped in a profiler
  range of that name while the block runs; the first call of each range in
  `capture` copied into `captures`."""
  undo = []
  try:
    for rng, target in entries.items():
      found = resolve(target)
      if found is None:
        print(f'trace: entry {target} of range {rng} not found; its '
              'metrics read null', flush=True)
        continue
      mod, attr = found
      orig = getattr(mod, attr)

      def wrapper(*args, __orig=orig, __rng=rng, **kwargs):
        with torch.profiler.record_function(__rng):
          out = __orig(*args, **kwargs)
        if __rng in capture and __rng not in captures:
          captures[__rng] = (tree.move(args, None), tree.move(kwargs, None),
                             tree.move(out, None))
        return out

      functools.update_wrapper(wrapper, orig)
      setattr(mod, attr, wrapper)
      undo.append((mod, attr, orig))
    yield
  finally:
    for mod, attr, orig in reversed(undo):
      setattr(mod, attr, orig)


def profile(run, entries: dict, capture: set, device) -> dict:
  """Run `run(hooks)` (the driver's profiled window; `hooks` is a context
  manager to hold around exactly the window) and return the record."""
  captures: dict = {}
  marks = {}

  @contextlib.contextmanager
  def hooks():
    with wrapped_entries(entries, capture, captures):
      acts = [torch.profiler.ProfilerActivity.CPU]
      if device.type == 'cuda':
        acts.append(torch.profiler.ProfilerActivity.CUDA)
      with torch.profiler.profile(activities=acts) as prof:
        if device.type == 'cuda':
          torch.cuda.synchronize()
        marks['t0'] = time.perf_counter()
        with torch.profiler.record_function('bench.window'):
          yield
        if device.type == 'cuda':
          torch.cuda.synchronize()
        marks['t1'] = time.perf_counter()
    marks['prof'] = prof

  info = run(hooks)
  rec = parse(export(marks['prof']))
  rec.update(info)
  rec['captures'] = captures
  rec['host_window_s'] = marks['t1'] - marks['t0']
  return rec


def export(prof) -> dict:
  """The profiler's Chrome trace as a dict, through a file in TMPDIR that
  is removed at once."""
  fd, path = tempfile.mkstemp(suffix='.json')
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rt') as f:
      return json.load(f)
  finally:
    os.remove(path)


def parse(trace: dict) -> dict:
  """The record's trace part from a Chrome trace dict."""
  events = trace['traceEvents'] if isinstance(trace, dict) else trace
  ranges: dict = {}
  launches = {}
  ops = []
  for e in events:
    if e.get('ph') != 'X':
      continue
    cat = e.get('cat', '')
    if cat == 'user_annotation':
      ranges.setdefault(e['name'], []).append((float(e['ts']),
                                               float(e.get('dur', 0))))
    elif cat in LAUNCH_CATS:
      corr = (e.get('args') or {}).get('correlation')
      if corr is not None:
        launches[corr] = float(e['ts'])
    elif cat in DEVICE_CATS:
      ops.append((e['name'], float(e['ts']), float(e.get('dur', 0)),
                  (e.get('args') or {}).get('correlation'), cat))
  win = ranges.get('bench.window')
  if not win:
    raise RuntimeError('the trace has no bench.window range')
  w0, wd = win[0]
  w1 = w0 + wd
  # each range's intervals sorted by start, for the launch lookup
  spans = {name: sorted(v) for name, v in ranges.items()}
  out_ops = []
  for name, ts, dur, corr, cat in ops:
    at = launches.get(corr)
    names = [] if at is None else [r for r, iv in spans.items()
                                   if _inside(iv, at)]
    out_ops.append((name, ts, dur, names, cat, at))
  busy = union_length([(o[1], o[1] + o[2]) for o in out_ops],
                      (w0, w1))
  return {'window': (w0, w1), 'window_s': wd * 1e-6, 'busy_s': busy * 1e-6,
          'ops': out_ops, 'ranges': spans,
          'launch_matched': sum(bool(o[3]) for o in out_ops)}


def _inside(intervals: list, t: float) -> bool:
  """Whether `t` lies in one of the sorted, disjoint (start, dur)
  `intervals` (the calls of one range follow each other)."""
  i = bisect.bisect_right(intervals, (t, float('inf'))) - 1
  return i >= 0 and intervals[i][0] <= t <= intervals[i][0] + intervals[i][1]


def union_length(intervals: list, clip: tuple) -> float:
  """Length of the union of (start, end) intervals inside `clip`."""
  lo, hi = clip
  total, cur_s, cur_e = 0.0, None, None
  for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
    if e <= s:
      continue
    if cur_e is None or s > cur_e:
      if cur_e is not None:
        total += cur_e - cur_s
      cur_s, cur_e = s, e
    else:
      cur_e = max(cur_e, e)
  if cur_e is not None:
    total += cur_e - cur_s
  return total


def idle_gaps(rec: dict) -> list:
  """(start, end) of every stretch of the window with no device op."""
  w0, w1 = rec['window']
  gaps, t = [], w0
  for s, e in sorted((o[1], o[1] + o[2]) for o in rec['ops']):
    if s > t:
      gaps.append((t, min(s, w1)))
    t = max(t, e)
    if t >= w1:
      break
  if t < w1:
    gaps.append((t, w1))
  return [(s, e) for s, e in gaps if e > s]


def host_label(rec: dict, t: float) -> str:
  """The innermost profiler range that the host was in at time `t` (the
  shortest that holds it), or 'outside ranges'."""
  best, best_d = 'outside ranges', float('inf')
  for name, iv in rec['ranges'].items():
    if name == 'bench.window':
      continue
    for s, d in iv:
      if s <= t <= s + d and d < best_d:
        best, best_d = name, d
  return best


def breakdown(rec: dict, top: int = 10) -> dict:
  """The device operations that took most time (summed by name) and the
  idle time of the window summed by what the host was doing at each gap's
  middle, each in seconds, the largest first."""
  by_op: dict = {}
  w0, w1 = rec['window']
  for name, ts, dur, *_ in rec['ops']:
    d = max(0.0, min(ts + dur, w1) - max(ts, w0))
    by_op[name] = by_op.get(name, 0.0) + d * 1e-6
  by_host: dict = {}
  for s, e in idle_gaps(rec):
    label = host_label(rec, 0.5 * (s + e))
    by_host[label] = by_host.get(label, 0.0) + (e - s) * 1e-6
  top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
  top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
  return {'device_ops': [[_short(k), v] for k, v in top_ops],
          'idle_gaps': [[k, v] for k, v in top_gaps]}


def _short(name: str, limit: int = 120) -> str:
  return name if len(name) <= limit else name[:limit - 3] + '...'


def op_sites(rec: dict, top: int = 8) -> list:
  """[(name, seconds, where)] of the device operations that took most
  time, `where` the innermost ranges (the shortest call of each name that
  launched them) with the seconds launched from each."""
  by_op: dict = {}
  for name, _, dur, ranges, _, at in rec['ops']:
    site = _innermost(rec, ranges, at)
    d = by_op.setdefault(name, {})
    d[site] = d.get(site, 0.0) + dur * 1e-6
  out = sorted(by_op.items(), key=lambda kv: -sum(kv[1].values()))[:top]
  return [(name, sum(s.values()),
           ', '.join(f'{k} {v:.6f} s' for k, v in
                     sorted(s.items(), key=lambda kv: -kv[1])))
          for name, s in out]


def _innermost(rec: dict, ranges: list, at) -> str:
  best, best_d = 'outside ranges', float('inf')
  for name in ranges:
    if name == 'bench.window':
      continue
    iv = rec['ranges'][name]
    i = bisect.bisect_right(iv, (at, float('inf'))) - 1
    if i >= 0 and iv[i][1] < best_d:
      best, best_d = name, iv[i][1]
  return best

