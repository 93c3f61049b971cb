"""K4: the contact rows of the compacted pyramidal pools in one CUDA kernel.

Hand-written kernel (csrc/contact_rows.cu). It replaces no TPU kernel: the
JAX package builds these rows in plain jnp, as the plain version here,
physics/constraint.py:contacts_compacted_plain, does in torch. The kernel
takes, per env, the pool positions that `constraint.deepest` selected and
writes the c block (c_J, c_D masked by c_active, c_aref, c_active, c_pos)
without any (B, K, nv, 3) intermediate in device memory.

Fit rule: one block keeps one env's c_J block (ncr rows of nv), its cdof
and qvel and the selected slots' scalars in shared memory, so a model runs
on the kernel when the library's own `contact_rows_smem_bytes(nv, K3, K1,
A)` (csrc/contact_rows.cu) is at most the 227 KB a Hopper block may opt
into; the G1 (nv 35, caps 32 + 16, A 2, ncr 144) needs about 26 KB. The
dispatch (physics/constraint.py) asks only on CUDA, where the library is
built.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mjlab_torch.ops import _build
from mjlab_torch.ops import work as _work

NAME = 'contact_rows'


@functools.cache
def smem_bytes(nv: int, K3: int, K1: int, A: int) -> int:
  """Shared memory one block of the kernel needs, as the library reports
  it (builds the library on first use)."""
  fn = _build.library(NAME).contact_rows_smem_bytes
  fn.restype = ctypes.c_size_t
  fn.argtypes = [ctypes.c_int] * 4
  return int(fn(nv, K3, K1, A))


def fits(nv: int, K3: int, K1: int, A: int) -> bool:
  return smem_bytes(nv, K3, K1, A) <= _build.SMEM_LIMIT


def _require_rows(t, name: str, B: int, K: int) -> None:
  """A (B, K) int64 CUDA view whose rows are contiguous (a column slice of
  a sort's indices)."""
  if t.device.type != 'cuda' or t.dtype != torch.long:
    raise TypeError(f'{name} must be a CUDA int64 tensor, got {t.dtype} on '
                    f'{t.device}')
  if tuple(t.shape) != (B, K) or (K > 1 and t.stride(1) != 1):
    raise ValueError(f'{name} has shape {tuple(t.shape)} and strides '
                     f'{t.stride()}, expected ({B}, {K}) with unit stride')


def contact_rows_cuda(pdist, sel3, sel1, pos, frame, friction, solref,
                      solimp, cdof, subtree_com, qvel, body_invweight0,
                      timestep, impratio, tab, dim, ancd, *, np3: int,
                      A: int, refsafe: bool):
  """Kernel path, float32 CUDA tensors with a leading env axis B:
  pdist (B, ncon) dist - includemargin; sel3 (B, K3), sel1 (B, K1) int64
  positions in the frictional and frictionless pools; pos (B, ncon, 3),
  frame (B, ncon, 3, 3), friction (B, ncon, 5), solref (B, ncon, 2),
  solimp (B, ncon, 5); cdof (B, nv, 6), subtree_com (B, nbody, 3), qvel
  (B, nv); body_invweight0 (nbody, 2), shared by every env; timestep and
  impratio one element each; the static pool entries, the frictional
  pool's np3 first: tab (np, 5) int32 (slot, body1, body2, root1, root2),
  dim (np,) int32 (condim), ancd (np, nv) int8 (signed ancestor delta).
  Returns (c_J (B, ncr, nv), c_D, c_aref, c_active (bool), c_pos), each
  (B, ncr), ncr = 2 A K3 + K1."""
  B, ncon = pdist.shape
  K3, K1 = sel3.shape[1], sel1.shape[1]
  nv, nbody = qvel.shape[1], subtree_com.shape[1]
  npool = tab.shape[0]
  if body_invweight0.dim() != 2:
    raise ValueError(
        'contact_rows reads body_invweight0 as one (nbody, 2) table shared '
        f'by every env, got shape {tuple(body_invweight0.shape)}')
  ins = [t.contiguous() for t in (pdist, pos, frame, friction, solref,
                                  solimp, cdof, subtree_com, qvel,
                                  body_invweight0)]
  names = ('pdist', 'pos', 'frame', 'friction', 'solref', 'solimp', 'cdof',
           'subtree_com', 'qvel', 'body_invweight0')
  shapes = ((B, ncon), (B, ncon, 3), (B, ncon, 3, 3), (B, ncon, 5),
            (B, ncon, 2), (B, ncon, 5), (B, nv, 6), (B, nbody, 3), (B, nv),
            (nbody, 2))
  for t, name, shape in zip(ins, names, shapes):
    _build.require(t, name, shape)
  scalars = [t.reshape(1) for t in (timestep, impratio)]
  for t, name in zip(scalars, ('timestep', 'impratio')):
    _build.require(t, name, (1,))
  _require_rows(sel3, 'sel3', B, K3)
  _require_rows(sel1, 'sel1', B, K1)
  _build.require(tab, 'tab', (npool, 5), torch.int32)
  _build.require(dim, 'dim', (npool,), torch.int32)
  _build.require(ancd, 'ancd', (npool, nv), torch.int8)
  if not fits(nv, K3, K1, A):
    raise ValueError(
        f'contact_rows kernel needs {smem_bytes(nv, K3, K1, A)} bytes of '
        f'shared memory (A = {A}), over the {_build.SMEM_LIMIT} a block '
        'may use')
  ncr = 2 * A * K3 + K1
  out = (torch.empty((B, ncr, nv), dtype=torch.float32, device=qvel.device),
         *(torch.empty((B, ncr), dtype=dt, device=qvel.device)
           for dt in (torch.float32, torch.float32, torch.bool,
                      torch.float32)))
  lib = _build.library(NAME)
  fn = lib.contact_rows_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
      ctypes.c_int64] * 2 + [ctypes.c_void_p]
  ptrs = [t.data_ptr() for t in (ins[0], sel3, sel1, *ins[1:], *scalars,
                                 tab, dim, ancd, *out)]
  ptrs_c = (ctypes.c_void_p * len(ptrs))(*ptrs)
  err = fn(ctypes.addressof(ptrs_c), B, ncon, nbody, nv, K3, K1, int(np3),
           int(A), int(bool(refsafe)), sel3.stride(0), sel1.stride(0),
           _build.stream_ptr(qvel))
  _build.check(lib, NAME, err)
  _build.LAUNCHES[NAME] += 1
  if _build.COUNTER is not None:
    _build.COUNTER.charge(NAME, lambda: _work.contact_rows_work(
        B, nv, nbody, K3, K1, A, npool))
  return out
