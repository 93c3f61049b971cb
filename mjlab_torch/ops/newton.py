"""K2: the whole pyramidal Newton constraint solve in one CUDA kernel.

Hand-written kernel (csrc/newton.cu) in place of the TPU kernel
mjlab_tpu/ops/newton.py:_make_kernel. Its plain version is
physics/solver.py:newton_plain (the counterpart of the JAX `_newton_jax`).

Fit rule (the model-class gate): the kernel keeps one env's M and H
(packed lower triangles), its dense contact Jacobian (ncr rows of n
rounded up to 4) and its row vectors in the shared memory of one block, so
a model runs on the kernel when the kernel library's own
`newton_smem_bytes(n, ncr, nl)` (csrc/newton.cu, the one owner of the
layout) is at most the 227 KB a Hopper block may opt into. The Unitree G1
flat scene (n=35, ncr=144, nl=29) needs about 34 KB; G1 tracking compiles
to the same widths (533 candidate slots, caps 32 + 16, ncr 144), so the
kernel serves it too. The Go1 flat scene (n=18, 57 uncompacted slots of
condim 3, ncr=228, nl=12) fits as well. The gate is asked only on CUDA,
where the library is built.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mjlab_torch.ops import _build

NAME = 'newton'
SMEM_LIMIT = _build.SMEM_LIMIT
MASKS = ('c_act', 'l_act', 'f_act')  # torch.bool, read as bytes


@functools.cache
def newton_smem_bytes(n: int, ncr: int, nl: int) -> int:
  """Shared memory one block of the kernel needs, as the library reports
  it (builds the library on first use)."""
  fn = _build.library(NAME).newton_smem_bytes
  fn.restype = ctypes.c_size_t
  fn.argtypes = [ctypes.c_int] * 3
  return int(fn(n, ncr, nl))


def fits(n: int, ncr: int, nl: int) -> bool:
  return newton_smem_bytes(n, ncr, nl) <= SMEM_LIMIT


_device_ldof: dict = {}


def _ldof_tensor(ldof: tuple, device) -> torch.Tensor:
  key = (ldof, str(device))
  t = _device_ldof.get(key)
  if t is None:
    t = torch.as_tensor(ldof, dtype=torch.int32, device=device)
    _device_ldof[key] = t
  return t


def newton_solve_cuda(M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD,
                      l_act, f_aref, fD, floss, f_act, *, iterations: int,
                      ls_polish: int, ldof: tuple, grad_th: float):
  """Kernel path, float32 CUDA tensors with a leading env axis B:
  M (B,n,n); a0, ws, f_aref, fD, floss, f_act (B,n); cJ (B,ncr,n);
  c_aref, cD, c_act (B,ncr); l_sign, l_aref, lD, l_act (B,nl). The
  activity masks c_act, l_act, f_act are torch.bool and the kernel reads
  their bytes. Returns (qacc (B,n), ff (B,n), fl (B,nl), fc (B,ncr))."""
  B, n, _ = M.shape
  ncr = cJ.shape[1]
  nl = l_sign.shape[1]
  if len(ldof) != nl:
    raise ValueError(f'ldof has {len(ldof)} entries, expected {nl}')
  args = [t.contiguous() for t in (M, a0, ws, cJ, c_aref, cD, c_act, l_sign,
                                   l_aref, lD, l_act, f_aref, fD, floss,
                                   f_act)]
  names = ('M', 'a0', 'ws', 'cJ', 'c_aref', 'cD', 'c_act', 'l_sign',
           'l_aref', 'lD', 'l_act', 'f_aref', 'fD', 'floss', 'f_act')
  shapes = ((B, n, n), (B, n), (B, n), (B, ncr, n), (B, ncr), (B, ncr),
            (B, ncr), (B, nl), (B, nl), (B, nl), (B, nl), (B, n), (B, n),
            (B, n), (B, n))
  for t, name, shape in zip(args, names, shapes):
    _build.require(t, name, shape,
                   torch.bool if name in MASKS else torch.float32)
  if not fits(n, ncr, nl):
    raise ValueError(
        f'newton kernel needs {newton_smem_bytes(n, ncr, nl)} bytes of '
        f'shared memory, over the {SMEM_LIMIT} a block may use')
  lib = _build.library(NAME)
  fn = lib.newton_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
      ctypes.c_float, ctypes.c_void_p]
  x = torch.empty_like(args[1])
  ff = torch.empty_like(args[1])
  fl = torch.empty_like(args[7])
  fc = torch.empty_like(args[4])
  ptrs = [t.data_ptr() for t in args] + [
      _ldof_tensor(tuple(int(i) for i in ldof), M.device).data_ptr(),
      x.data_ptr(), ff.data_ptr(), fl.data_ptr(), fc.data_ptr()]
  ptrs_c = (ctypes.c_void_p * len(ptrs))(*ptrs)
  err = fn(ctypes.addressof(ptrs_c), B, n, ncr, nl, int(iterations),
           int(ls_polish), float(grad_th), _build.stream_ptr(M))
  _build.check(lib, NAME, err)
  _build.LAUNCHES[NAME] += 1
  return x, ff, fl, fc
