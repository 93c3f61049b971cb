"""Performance profiling harness of the port: per-stage times, a roofline
of the substep and the env-step, and a torch.profiler trace.

Counterpart of mjlab_tpu/scripts/profile.py:

  python -m mjlab_torch.scripts.profile --task Mjlab-Velocity-Flat-Unitree-G1 \\
      --num-envs 4096
      the time of every stage of the physics pipeline, each stage called
      alone on the output of the one before, then of the fused substep
      and the full env.step.
  ... --roofline
      the FLOPs and bytes of one physics substep and one env.step, counted
      op by op as the eager program dispatches them (utils/op_count.py;
      each hand-written kernel charges its own, ops/work.py) -> achieved
      FLOP/s, apparent bandwidth, and the roofline position against the
      card's peaks (`--chip`).
  ... --trace DIR
      a torch.profiler trace of a few env-steps in DIR (a .json that
      ui.perfetto.dev and chrome://tracing open), the top device kernels
      and host ops by total time, and the card's DRAM byte counters where
      CUPTI gives them.

Runs on the GPU unless `--device cpu` is given; on a host without CUDA the
default raises. Stage times are standalone calls timed between two
device synchronizations, each with the host's time to launch it. The
stages from kinematics to rne are the plain ones, which the fused
substep replaces by one K3 launch, so they sum to more than the fused
substep: use them for attribution, the fused numbers for throughput. The
op count is the work of the unfused eager program, not XLA's number for
the JAX package's compiled step.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import time

from mjlab_torch.ops.work import F32_FLOPS_PER_S, HBM_BYTES_PER_S

# Public peak specs (f32 FLOP/s outside the tensor cores, HBM bytes/s).
_CHIP_PEAKS = {
    'h100-sxm': (F32_FLOPS_PER_S, HBM_BYTES_PER_S),
    'cpu': (float('nan'), float('nan')),
}
# CUPTI counters of the bytes the card's DRAM read and wrote
DRAM_METRICS = ('dram__bytes_read.sum', 'dram__bytes_write.sum')


def _sync(device) -> None:
  import torch
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _timeit(name, fn, args, reps, device):
  out = fn(*args)
  _sync(device)
  t0 = time.perf_counter()
  for _ in range(reps):
    out = fn(*args)
  _sync(device)
  dt = (time.perf_counter() - t0) / reps
  print(f'{name:30s} {dt * 1e3:8.3f} ms', flush=True)
  return out, dt


def _phase_report(env, state, reps, device) -> dict:
  """{label: seconds} of each stage, chained on the stage before."""
  from mjlab_torch.physics import (collision, constraint, kinematics,
                                   pipeline, smooth, solver)

  model, data = state.model, state.data
  s = model.stat
  lay = constraint.efc_layout(s)
  print(f'pairs ncon_max={s.pairs.ncon_max} ncon_cap={s.ncon_cap} '
        f'nv={s.nv}')
  print(f'efc rows: nf={lay.nf} nl={lay.nl} ncr={lay.ncr} '
        f'total={lay.nefc}')
  times = {}

  def timeit(name, fn, *args):
    out, times[name] = _timeit(name, fn, args, reps, device)
    return out

  timeit('full substep (fused)', pipeline.step, model, data)
  d = timeit('kinematics', kinematics.kinematics, model, data)
  d = timeit('com_pos', kinematics.com_pos, model, d)
  d = timeit('crb', smooth.crb, model, d)
  d = timeit('collision narrowphase', collision.collision, model, d)
  d = timeit('transmission', smooth.transmission, model, d)
  d = timeit('com_vel', kinematics.com_vel, model, d)
  d = timeit('passive', smooth.passive, model, d)
  d = timeit('rne', smooth.rne, model, d)
  d = timeit('actuation', smooth.actuation, model, d)
  d = timeit('fwd_smooth', smooth.fwd_smooth, model, d)
  timeit('make_efc', constraint.make_efc, model, d)

  def solve_only(m, dd):
    return solver.solve(m, dd, constraint.make_efc(m, dd))

  timeit('make_efc + solve', solve_only, model, d)
  return times


def _roofline_report(env, state, action, reps, peaks, device) -> dict:
  """{program: {flops, bytes, seconds, ops, kernels}} of one physics
  substep and one env.step: one pass under the op counter, then `reps`
  timed calls without it."""
  from mjlab_torch.physics import pipeline
  from mjlab_torch.utils.op_count import OpCounter

  peak_flops, peak_bw = peaks
  result = {}

  def analyze(name, fn, *args):
    with OpCounter(device) as count:
      fn(*args)
    _sync(device)
    flops, bytes_acc = count.flops, count.bytes
    _, dt = _timeit(name, fn, args, reps, device)
    tf = flops / dt / 1e12
    gbs = bytes_acc / dt / 1e9
    print(f'  flops {flops / 1e9:9.2f} GFLOP -> {tf:7.2f} TFLOP/s '
          f'({100 * tf * 1e12 / peak_flops:5.1f}% of f32 peak; eager op '
          'count)')
    print(f'  bytes {bytes_acc / 1e9:9.2f} GB    -> {gbs:7.1f} GB/s '
          f'({100 * gbs * 1e9 / peak_bw:5.1f}% of HBM peak, apparent; '
          'eager op count)')
    ai = flops / max(bytes_acc, 1.0)
    ridge = peak_flops / peak_bw
    regime = 'compute' if ai > ridge else 'bandwidth'
    print(f'  intensity {ai:6.2f} FLOP/B (ridge {ridge:.0f} -> '
          f'{regime}-bound)')
    calls = sum(c for c, _, _ in count.ops.values())
    print(f'  {calls} aten ops; kernels (calls, GB, GFLOP): ' + (', '.join(
        f'{k} ({c}, {b / 1e9:.4f}, {f / 1e9:.4f})'
        for k, (c, b, f) in sorted(count.kernels.items())) or 'none'))
    top = sorted(count.ops.items(), key=lambda kv: -kv[1][1])[:8]
    print('  top aten ops by bytes (calls, GB, GFLOP): ' + ', '.join(
        f'{k} ({c}, {b / 1e9:.4f}, {f / 1e9:.4f})'
        for k, (c, b, f) in top), flush=True)
    result[name] = dict(flops=flops, bytes=bytes_acc, seconds=dt,
                        ops=calls, kernels=dict(count.kernels))

  analyze('physics substep', pipeline.step, state.model, state.data)
  analyze('full env.step', env.step_fn, state, action)
  return result


def _trace_events(path: str):
  """The events of the chrome trace at `path`, one at a time (a trace of
  the CPU path holds hundreds of thousands; they are never all held as
  objects at once)."""
  with open(path) as f:
    text = f.read()
  decoder = json.JSONDecoder()
  skip = re.compile(r'[\s,]*')
  i = skip.match(text, text.index('[', text.index('"traceEvents"')) + 1).end()
  while text[i] != ']':
    event, i = decoder.raw_decode(text, i)
    yield event
    i = skip.match(text, i).end()


def _trace_summary(path: str, top: int = 25) -> dict:
  """Top device kernels and top host ops by total time in the trace at
  `path`; returns {'kernels': {name: ms}, 'host': {name: ms}}, every
  name."""
  tot = {'kernel': {}, 'cpu_op': {}}
  for ev in _trace_events(path):
    by_name = tot.get(ev.get('cat'))
    if by_name is not None and 'dur' in ev:
      by_name[ev['name']] = by_name.get(ev['name'], 0.0) + ev['dur'] / 1e3
  for cat, label in (('kernel', 'device kernels'), ('cpu_op', 'host ops')):
    ranked = sorted(tot[cat].items(), key=lambda kv: -kv[1])[:top]
    print(f'--- {label}: top {len(ranked)} by total time ---')
    for k, v in ranked:
      print(f'  {v:10.3f} ms  {k[:90]}')
  return {'kernels': tot['kernel'], 'host': tot['cpu_op']}


def _trace_bandwidth(step, state, action, trace_dir: str, device) -> dict:
  """The card's measured DRAM bytes over one env-step, from CUPTI's
  counters (DRAM_METRICS, per kernel), divided by the busy window of the
  measured kernels. Returns {'available': bool, 'reason' or the metrics
  and 'window_s'}."""
  if device.type != 'cuda':
    reason = 'no CUDA device'
    print(f'[trace] memory counters unavailable ({reason})')
    return {'available': False, 'reason': reason}
  import torch
  from torch.profiler import ProfilerActivity, profile
  path = os.path.join(trace_dir, 'counters.json')
  try:
    cfg = torch.profiler._ExperimentalConfig(
        profiler_metrics=list(DRAM_METRICS),
        profiler_measure_per_kernel=True)
    with profile(activities=[ProfilerActivity.CUDA],
                 experimental_config=cfg) as prof:
      step(state, action)
      _sync(device)
    prof.export_chrome_trace(path)
  except RuntimeError as e:
    print(f'[trace] memory counters unavailable ({e})')
    return {'available': False, 'reason': str(e)}
  agg = {}
  t0, t1 = math.inf, 0.0
  for ev in _trace_events(path):
    vals = {k: v for k, v in (ev.get('args') or {}).items()
            if k in DRAM_METRICS and isinstance(v, (int, float))}
    if not vals:
      continue
    for k, v in vals.items():
      agg[k] = agg.get(k, 0) + v
    if 'dur' in ev:
      t0 = min(t0, ev['ts'])
      t1 = max(t1, ev['ts'] + ev['dur'])
  if not agg:
    reason = (f'the profiler returned no {" or ".join(DRAM_METRICS)} '
              'values and raised no error')
    print(f'[trace] memory counters unavailable ({reason})')
    return {'available': False, 'reason': reason}
  window_s = max((t1 - t0) / 1e6, 1e-9) if t1 > 0 else float('nan')
  print(f'--- measured memory counters (busy window {window_s * 1e3:.2f} '
        'ms) ---')
  for k, v in sorted(agg.items(), key=lambda kv: -kv[1]):
    print(f'  {k}: {v:,.0f}  -> {v / window_s / 1e9:.1f} GB/s over the '
          'window')
  return {'available': True, 'window_s': window_s, **agg}


def _trace(step, state, action, n, trace_dir, device):
  """`n` env-steps under torch.profiler; the trace goes to trace_dir.
  Returns (the state after them, {'path', 'kernels', 'host',
  'counters'})."""
  from torch.profiler import ProfilerActivity, profile
  os.makedirs(trace_dir, exist_ok=True)
  acts = [ProfilerActivity.CPU]
  if device.type == 'cuda':
    acts.append(ProfilerActivity.CUDA)
  with profile(activities=acts) as prof:
    for _ in range(n):
      state, _ = step(state, action)
    _sync(device)
  path = os.path.join(trace_dir, f'env_step_{os.getpid()}.json')
  prof.export_chrome_trace(path)
  print(f'trace written to {path} (open it in ui.perfetto.dev or '
        'chrome://tracing)')
  summary = _trace_summary(path)
  summary['counters'] = _trace_bandwidth(step, state, action, trace_dir,
                                         device)
  return state, dict(path=path, **summary)


def main(argv=None) -> dict:
  """Run the profile; returns what it printed: {'phases': {label: s}} or
  {'roofline': {program: {...}}}, 'trace' (with --trace) and
  'env_step_s'."""
  parser = argparse.ArgumentParser(
      description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
  parser.add_argument('--task', default='Mjlab-Velocity-Flat-Unitree-G1')
  parser.add_argument('--num-envs', type=int, default=4096)
  parser.add_argument('--reps', type=int, default=20)
  parser.add_argument('--roofline', action='store_true',
                      help='eager op-count roofline instead of stages')
  parser.add_argument('--trace', default=None, metavar='DIR',
                      help='write a torch.profiler trace of the hot loop')
  parser.add_argument('--chip', default='h100-sxm',
                      choices=sorted(_CHIP_PEAKS),
                      help='peak specs used for roofline percentages')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (the default) or 'cpu'")
  args = parser.parse_args(argv)

  import torch

  from mjlab_torch.physics.io import resolve_device
  from mjlab_torch.tasks import registry

  device = resolve_device(args.device)
  cfg = registry.load_cfg(args.task)
  cfg.scene.num_envs = args.num_envs
  env = registry.make(args.task, cfg=cfg, device=device)
  state, _ = env.init_state(0)
  print(f'=== {args.task} N={args.num_envs} device={device} ===')
  if device.type == 'cuda':
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

  gen = torch.Generator(device=device).manual_seed(0)
  action = 0.5 * torch.randn((args.num_envs, env.action_dim), generator=gen,
                             device=device)

  report = {}
  if args.roofline:
    report['roofline'] = _roofline_report(env, state, action, args.reps,
                                          _CHIP_PEAKS[args.chip], device)
  else:
    report['phases'] = _phase_report(env, state, args.reps, device)

  step = env.step_fn
  st, _ = step(state, action)
  _sync(device)
  if args.trace:
    st, report['trace'] = _trace(step, st, action, max(3, args.reps // 4),
                                 args.trace, device)
  t0 = time.perf_counter()
  for _ in range(args.reps):
    st, _ = step(st, action)
  _sync(device)
  dt = (time.perf_counter() - t0) / args.reps
  print(f'{"full env.step":30s} {dt * 1e3:8.3f} ms  '
        f'({args.num_envs / dt:,.0f} env-steps/s)', flush=True)
  report['env_step_s'] = dt
  return report


if __name__ == '__main__':
  main()
