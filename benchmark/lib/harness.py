"""One run of one cell: build and warm the program, measure the window,
optionally trace a short window, then judge the program's captures against
the frozen reference, and print the result as the last line of stdout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` the result's metrics are the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, read from the traced window by
benchmark/metrics/<name>.py. The numbers compared with the reference are
printed beside their limits as the last lines of stderr and, under
`checks`, as the last key of the result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from benchmark.lib import check, spec, trace
from benchmark.lib.drivers import DRIVERS

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mjlab_tpu')


def forbidden_modules() -> list:
  """Loaded modules whose top-level name (before the first dot) is one of
  FORBIDDEN, compared whole."""
  return sorted({m for m in list(sys.modules)
                 if m.split('.')[0] in FORBIDDEN})


def card() -> str:
  try:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=30).stdout.strip()
  except (OSError, subprocess.SubprocessError) as e:
    return f'nvidia-smi unavailable ({e})'


def per_layer(cell, drv, device) -> 'tuple[dict, dict, dict]':
  """(metrics, device numbers, breakdown) of the traced window."""
  mods = {m['name']: spec.metric_module(m['name'], cell.metrics_dir)
          for m in cell.per_layer}
  entries, capture = {}, set()
  for name, mod in mods.items():
    for rng, target in getattr(mod, 'ENTRIES', {}).items():
      if entries.setdefault(rng, target) != target:
        raise ValueError(f'metric {name} points range {rng} at {target}, '
                         f'another metric at {entries[rng]}')
    capture |= set(getattr(mod, 'CAPTURE', ()))
  rec = trace.profile(drv.profiled, entries, capture, device)
  rec['num_envs'] = drv.num_envs
  rec['kind'] = (torch.cuda.get_device_name(device)
                 if device.type == 'cuda' else 'cpu')
  print(f'trace: {len(rec["ops"])} device operations in '
        f'{rec["window_s"]:.4f} s, {rec["launch_matched"]} matched to their '
        f'launch; busy {rec["busy_s"]:.4f} s', flush=True)
  units = {m['name']: m['unit'] for m in cell.per_layer}
  metrics = {}
  for name, mod in mods.items():
    v = mod.read(rec)
    if v is None:
      print(f'trace: {name} found nothing to read; left out', flush=True)
      continue
    metrics[name] = {'value': float(v), 'unit': units[name]}
  dev = {'busy_s': rec['busy_s'], 'window_s': rec['window_s']}
  for name, secs, where in trace.op_sites(rec):
    print(f'trace: {secs:.6f} s of {name[:90]} launched from {where}',
          flush=True)
  return metrics, dev, trace.breakdown(rec)


def run_cell(cell, seed: int, seconds: float, traced: bool, device='cuda',
             t0: 'float | None' = None, overrides: 'dict | None' = None,
             variants: tuple = ()) -> dict:
  """One run. Returns the result dict (with `checks` last) and, under
  `variants`, the readings of each variant of the reference in the
  program's place (the control and the faults, for calibration)."""
  t0 = time.perf_counter() if t0 is None else t0
  device = torch.device(device)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  drv = DRIVERS[cell.traffic['driver']](cell, seed, device, overrides)
  drv.setup()
  setup_s = time.perf_counter() - t0
  print(f'setup: {setup_s:.3f} s', flush=True)
  if device.type == 'cuda':
    torch.cuda.reset_peak_memory_stats(device)
  win = drv.window(seconds)
  peak = (torch.cuda.max_memory_allocated(device)
          if device.type == 'cuda' else 0)
  dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
         'kind': (torch.cuda.get_device_name(device)
                  if device.type == 'cuda' else device.type),
         'count': cell.chips, 'memory_peak_bytes': int(peak)}
  result = {'correct': False, 'attempted': win['attempted'],
            'failed': win['failed']}
  e2e = dict(win['values'], setup_s=setup_s)
  units = {m['name']: m['unit'] for m in cell.end_to_end}
  breakdown = None
  if traced:
    metrics, extra, breakdown = per_layer(cell, drv, device)
    dev.update(extra)
  else:
    metrics = {k: {'value': float(e2e[k]), 'unit': units[k]}
               for k in units if k in e2e}
  captures = drv.captures
  drv.free()
  t_ref = time.perf_counter()
  reference = check.Reference(cell, seed, device, overrides)
  prog = check.program_outputs(captures)
  ref = reference.outputs(captures)
  values = check.readings(prog, ref, reference.managed(captures, prog))
  limits = cell.traffic['limits']
  ok, checks = check.judge(values, limits)
  print(f'reference: {time.perf_counter() - t_ref:.3f} s; readings '
        f'{json.dumps(values)}', flush=True)
  result.update(correct=bool(ok), metrics=metrics,
                device=dev)
  if breakdown is not None:
    result['breakdown'] = breakdown
  result['checks'] = checks
  if variants:
    result['variants'] = {'program': values}
    for v in variants:
      side = reference.outputs(captures, v)
      result['variants'][v] = check.readings(
          side, ref, reference.managed(captures, side))
  return result


def print_result(result: dict) -> None:
  if result['device']['platform'] == 'gpu':
    print(f'card: {card()}', file=sys.stderr, flush=True)
  print(f'failed: {result["failed"]} of {result["attempted"]} env-steps '
        '(envs the port reset after a non-finite state)', file=sys.stderr)
  for name, c in result['checks'].items():
    print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})',
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(result), flush=True)


def main(argv: list, t0: float) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seed', type=int, required=True)
  ap.add_argument('--seconds', type=float, required=True)
  ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  cell = spec.load_cell(args.workload)
  if not torch.cuda.is_available() or \
      torch.cuda.device_count() < cell.chips:
    print(f'{args.workload} needs {cell.chips} CUDA device(s); '
          f'cuda available: {torch.cuda.is_available()}', file=sys.stderr)
    return 2
  result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    device='cuda', t0=t0)
  bad = forbidden_modules()
  if bad:
    print(f'modules of {FORBIDDEN} were loaded: {bad}', file=sys.stderr)
    return 3
  print_result(result)
  return 0
