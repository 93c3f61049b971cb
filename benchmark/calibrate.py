"""The readings that a cell's limits are set from, on the card: for each
seed, one run of the cell (set-up, a short window, the reference check),
the program's readings against the reference, and the readings of each
variant of the reference put in the program's place (`tf32`, the control;
the faults `half_batch`, `altered_answer` and `few_envs`: see
benchmark/lib/check.py). All seeds run in one process, one after another;
each prints one JSON line.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--variants tf32,few_envs]

The benchmark's own runs never run the variants.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'),
                 ('CUDA_CACHE_PATH', 'cuda_cache')):
  os.environ[var] = os.path.join(ROOT, 'build', sub)
sys.path[:0] = [ROOT, os.path.join(ROOT, 'benchmark', 'reference')]


def main(argv) -> int:
  import torch

  from benchmark.lib import harness, spec
  ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  ap.add_argument('--workload', required=True)
  ap.add_argument('--seeds', required=True)
  ap.add_argument('--seconds', type=float, default=3.0)
  ap.add_argument('--variants', default='tf32')
  args = ap.parse_args(argv)
  if not torch.cuda.is_available():
    print('calibrate: needs a CUDA device', file=sys.stderr)
    return 2
  cell = spec.load_cell(args.workload)
  variants = tuple(v for v in args.variants.split(',') if v)
  for seed in (int(s) for s in args.seeds.split(',')):
    t0 = time.perf_counter()
    res = harness.run_cell(cell, seed, args.seconds, False, device='cuda',
                           t0=t0, variants=variants)
    print(json.dumps({'seed': seed, 'correct': res['correct'],
                      'readings': res.get('variants', {}),
                      'seconds': time.perf_counter() - t0}), flush=True)
    torch.cuda.empty_cache()
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
