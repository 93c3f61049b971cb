"""Build and load the port's hand-written CUDA kernels.

Each source under mjlab_torch/csrc/ is compiled by `nvcc` for Hopper
(`sm_90a`) into its own shared library with a plain C interface, loaded
with ctypes. Builds go to build/torch_kernels/ at the repository root
(listed in .gitignore), named by a hash of the source, of every header
under csrc/ (`*.cuh`, found by `-I csrc`) and of the flags, so an edited
source or header is rebuilt and an unchanged one is reused. All sources are
compiled by concurrent nvcc processes on first use.

Nothing is built at import time: the CPU tests import every module on a
host without nvcc.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'torch_kernels'
SOURCES = ('pd_solve', 'newton', 'smooth', 'contact_rows')
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-lineinfo')

SMEM_LIMIT = 232448  # bytes of shared memory one Hopper block may use

# Kernel launches by kernel name; each wrapper adds one where it launches.
LAUNCHES: collections.Counter = collections.Counter()

# The active work counter (utils/op_count.py's OpCounter), or None. While
# one is active, each kernel wrapper charges its call's bytes and FLOPs
# (ops/work.py) to it: a ctypes launch is invisible to a dispatch mode.
COUNTER = None

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
  LAUNCHES.clear()


@contextlib.contextmanager
def counting(counter):
  """Within the block the kernel wrappers charge their work to `counter`
  (it needs a `charge(name, work)` method)."""
  global COUNTER
  prev, COUNTER = COUNTER, counter
  try:
    yield counter
  finally:
    COUNTER = prev


def _nvcc() -> str:
  for cand in (os.environ.get('CUDA_HOME', ''), '/usr/local/cuda'):
    p = Path(cand) / 'bin' / 'nvcc'
    if cand and p.exists():
      return str(p)
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                       'host with the CUDA toolkit')
  return found


def _target(name: str) -> Path:
  """The library of source `name`, named by what the compiler reads: the
  source, every shared header of csrc/, and the flags."""
  h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
  for header in sorted(CSRC.glob('*.cuh')):
    h.update(header.name.encode() + b'\0' + header.read_bytes())
  h.update(' '.join(NVCC_FLAGS).encode())
  return BUILD_DIR / f'lib{name}_{h.hexdigest()[:16]}.so'


def build_all(verbose: bool = False) -> dict:
  """Compile every missing kernel library, one nvcc per source, all at
  once. Returns {name: seconds} of the builds that ran."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  procs = {}
  t0 = time.perf_counter()
  for name in SOURCES:
    out = _target(name)
    if out.exists():
      continue
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
           str(CSRC / f'{name}.cu')]
    if verbose:
      cmd.insert(1, '-Xptxas=-v')
    procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT), tmp, out)
  times = {}
  errors = []
  for name, (proc, tmp, out) in procs.items():
    log, _ = proc.communicate()
    times[name] = time.perf_counter() - t0
    if proc.returncode != 0:
      errors.append(f'{name}.cu:\n{log.decode(errors="replace")}')
      continue
    if verbose and log:
      print(log.decode(errors='replace'))
    os.replace(tmp, out)
  if errors:
    raise RuntimeError('nvcc failed:\n' + '\n'.join(errors))
  return times


def library(name: str) -> ctypes.CDLL:
  """The loaded kernel library `name`, built first if needed."""
  with _lock:
    lib = _libs.get(name)
    if lib is None:
      path = _target(name)
      if not path.exists():
        build_all()
      lib = ctypes.CDLL(str(path))
      _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, prefix: str, err: int) -> None:
  """Raise if a launch returned a CUDA error code."""
  if err:
    fn = getattr(lib, f'{prefix}_error_string')
    fn.restype = ctypes.c_char_p
    fn.argtypes = [ctypes.c_int]
    raise RuntimeError(
        f'{prefix} kernel launch failed: {fn(err).decode()} ({err})')


def stream_ptr(t) -> int:
  return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, shape: tuple, dtype=torch.float32) -> None:
  """Device, dtype, shape and contiguity checks of a kernel argument."""
  if t.device.type != 'cuda':
    raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
  if t.dtype != dtype:
    raise TypeError(f'{name} must be {dtype}, got {t.dtype}')
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f'{name} has shape {tuple(t.shape)}, expected {shape}')
  if not t.is_contiguous():
    raise ValueError(f'{name} must be contiguous')
