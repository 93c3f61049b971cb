"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See benchmark/README.md.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths (the
# port's own kernels build under build/torch_kernels/)
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton'),
                 ('CUDA_CACHE_PATH', 'cuda_cache')):
  os.environ[var] = os.path.join(ROOT, 'build', sub)
os.environ['USE_FLAX'] = '0'
sys.path[:0] = [ROOT, os.path.join(ROOT, 'benchmark', 'reference')]

from benchmark.lib import harness  # noqa: E402

if __name__ == '__main__':
  sys.exit(harness.main(sys.argv[1:], T0))
