"""Whether torch.profiler reads the card's DRAM counters on this host, and
what stands in the way.

Prints the NVIDIA kernel module's `RmProfilingAdminOnly` parameter (1: only an
administrator may read performance counters, CUPTI's ERR_NVGPUCTRPERM)
and the process's user id, then profiles one float32 matrix product with
CUPTI's `dram__bytes_read.sum` and `dram__bytes_write.sum` (the metrics
scripts/profile.py asks for) in a child process with Kineto's log on,
and prints the counter values the trace holds (none, where the counters
are refused or this build of torch has no range profiler) and Kineto's
lines about them.

    python3 tools/cupti_counters.py

Needs one NVIDIA GPU. Changes no setting of the host.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

METRICS = ('dram__bytes_read.sum', 'dram__bytes_write.sum')

CHILD = """
import json, sys
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
a = torch.randn(4096, 4096, device='cuda')
torch.cuda.synchronize()
cfg = _ExperimentalConfig(profiler_metrics=list(%r),
                          profiler_measure_per_kernel=True)
with profile(activities=[ProfilerActivity.CUDA],
             experimental_config=cfg) as prof:
  a @ a
  torch.cuda.synchronize()
prof.export_chrome_trace(sys.argv[1])
with open(sys.argv[1]) as f:
  events = json.load(f)['traceEvents']
values = [{k: v for k, v in (e.get('args') or {}).items() if k in %r}
          for e in events]
print('counter values in the trace:', [v for v in values if v] or 'none')
""" % (METRICS, METRICS)


def main() -> None:
  params = '/proc/driver/nvidia/params'
  if os.path.exists(params):
    with open(params) as f:
      print(next((ln.strip() for ln in f
                  if ln.startswith('RmProfilingAdminOnly')),
                 'RmProfilingAdminOnly: not listed'))
  else:
    print(f'{params}: not present')
  print(f'uid {os.getuid()}', flush=True)
  with tempfile.TemporaryDirectory() as tmp:
    out = subprocess.run(
        [sys.executable, '-c', CHILD, os.path.join(tmp, 'trace.json')],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, 'KINETO_LOG_LEVEL': '0'})
  print(f'child exit {out.returncode}: {out.stdout.strip()}')
  for line in out.stderr.splitlines():
    if any(w in line for w in ('Cupti Profiler', 'Range', 'range',
                               'CUPTI_ERROR', 'Enabling GPU tracing',
                               'Traceback', 'Error')):
      print(f'  kineto: {line.strip()[:200]}')


if __name__ == '__main__':
  main()
