"""K3: fused smooth stage (kinematics through RNE) in one CUDA kernel.

Hand-written kernel (csrc/smooth.cu) in place of the TPU kernel
mjlab_tpu/ops/smooth_kernel.py:_make_kernel. Its plain version is
physics/smooth_fused.py:plain_all (kinematics -> com_pos -> com_vel -> crb
-> rne). `_Tree` is the static schedule the kernel walks; its `supported`
rule is the model-class gate (one FREE root joint, at most one HINGE or
SLIDE joint on every other body, no mocap bodies).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mjlab_torch.ops import _build
from mjlab_torch.physics.types import DisableBit, JointType

NAME = 'smooth'

OUT_KEYS = ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'xanchor', 'xaxis',
            'geom_xpos', 'geom_xmat', 'site_xpos', 'site_xmat',
            'subtree_com', 'cinr', 'cdof', 'cvel', 'cdof_dot', 'qM',
            'qfrc_bias')


class _Tree:
  """Static per-model schedule of the kernel's loops."""

  def __init__(self, s):
    self.nbody = int(s.nbody)
    self.njnt = int(s.njnt)
    self.nv = int(s.nv)
    self.nq = int(s.nq)
    self.ngeom = int(s.ngeom)
    self.nsite = int(s.nsite)
    # parent-before-child order, excluding the world body
    self.order = [int(b) for level in s.body_levels for b in level
                  if int(b) != 0]
    self.parent = [int(p) for p in s.body_parentid]
    self.jnt_of_body = [-1] * self.nbody
    for j in range(self.njnt):
      self.jnt_of_body[int(s.jnt_bodyid[j])] = j
    # qM sparsity: for dof i, the j <= i with ancestor_mask[body(i), j]
    anc = np.asarray(s.ancestor_mask)
    self.qm_pairs = [
        [j for j in range(i + 1) if anc[int(s.dof_bodyid[i]), j] > 0.5]
        for i in range(self.nv)]
    self.gravity_off = bool(s.disableflags & DisableBit.GRAVITY)
    tables = [
        ('order', self.order), ('parent', self.parent),
        ('jnt_of_body', self.jnt_of_body), ('jnt_type', s.jnt_type),
        ('jnt_qposadr', s.jnt_qposadr), ('jnt_dofadr', s.jnt_dofadr),
        ('rootid', s.body_rootid), ('geom_body', s.geom_bodyid),
        ('site_body', s.site_bodyid), ('body_dofadr', s.body_dofadr),
        ('body_dofnum', s.body_dofnum), ('dof_body', s.dof_bodyid),
        ('qm_ptr', np.cumsum([0] + [len(p) for p in self.qm_pairs])),
        ('qm_idx', [j for p in self.qm_pairs for j in p]),
    ]
    self.int_offsets = []
    parts = []
    off = 0
    for _, arr in tables:
      arr = np.asarray(arr, np.int32).reshape(-1)
      self.int_offsets.append(off)
      parts.append(arr)
      off += len(arr)
    self.int_table = np.concatenate(parts + [np.zeros(1, np.int32)])
    self._device_tables = {}

  def device_table(self, device) -> torch.Tensor:
    """The int table on `device`, uploaded once."""
    t = self._device_tables.get(device)
    if t is None:
      t = torch.as_tensor(self.int_table, device=device)
      self._device_tables[device] = t
    return t

  @staticmethod
  def supported(s) -> bool:
    if s.nmocap:
      return False
    jnt_per_body = np.zeros(s.nbody, np.int32)
    for j in range(int(s.njnt)):
      jnt_per_body[int(s.jnt_bodyid[j])] += 1
    if (jnt_per_body > 1).any():
      return False
    for j in range(int(s.njnt)):
      t = int(s.jnt_type[j])
      b = int(s.jnt_bodyid[j])
      if t == int(JointType.FREE):
        if int(s.body_parentid[b]) != 0:
          return False
      elif t not in (int(JointType.HINGE), int(JointType.SLIDE)):
        return False
    return True


@functools.lru_cache(maxsize=8)
def tree_of(s) -> _Tree:
  return _Tree(s)


def _float_table(m):
  """Model constants in one flat float table, with their offsets."""
  s = m.stat
  dt = m.dtype
  site = (torch.cat([m.site_pos, m.site_quat], -1) if s.nsite
          else torch.zeros((1, 7), dtype=dt, device=m.device))
  parts = [
      torch.cat([m.body_pos, m.body_quat, m.body_ipos, m.body_iquat,
                 m.body_inertia, m.body_mass[:, None]], -1),
      torch.cat([m.jnt_pos, m.jnt_axis], -1),
      torch.cat([m.geom_pos, m.geom_quat], -1),
      site, m.qpos0, m.dof_armature, m.opt.gravity]
  offsets = np.cumsum([0] + [p.numel() for p in parts])[:-1]
  return torch.cat([p.reshape(-1) for p in parts]), [int(o) for o in offsets]


def smooth_fused_cuda(m, qpos: torch.Tensor, qvel: torch.Tensor) -> dict:
  """Kernel path: qpos (B, nq), qvel (B, nv), float32 CUDA. Returns the
  smooth-stage outputs, batched on axis 0, keyed as Data fields."""
  s = m.stat
  tree = tree_of(s)
  B = qpos.shape[0]
  _build.require(qpos, 'qpos', (B, s.nq))
  _build.require(qvel, 'qvel', (B, s.nv))
  if m.dtype != torch.float32 or m.device != qpos.device:
    raise TypeError('model must be float32 on the data device')
  lib = _build.library(NAME)
  nb, nj, nv = tree.nbody, tree.njnt, tree.nv
  nj1, ng1, ns1 = max(nj, 1), max(tree.ngeom, 1), max(tree.nsite, 1)
  ftab, foffs = _float_table(m)
  itab = tree.device_table(qpos.device)
  dims = [B, nb, nj, nv, tree.nq, tree.ngeom, tree.nsite, len(tree.order),
          int(tree.gravity_off), nj1, ng1, ns1] + tree.int_offsets + foffs
  count = lib.smooth_dims_count
  count.restype = ctypes.c_int
  if count() != len(dims):
    raise RuntimeError('smooth kernel argument layout mismatch')
  shapes = [(nb, 3), (nb, 4), (nb, 3, 3), (nb, 3), (nb, 3, 3), (nj1, 3),
            (nj1, 3), (ng1, 3), (ng1, 3, 3), (ns1, 3), (ns1, 3, 3),
            (nb, 3), (nb, 6, 6), (nv, 6), (nb, 6), (nv, 6), (nv, nv), (nv,),
            (nb, 52)]
  outs = [torch.empty((B,) + sh, dtype=qpos.dtype, device=qpos.device)
          for sh in shapes]
  fn = lib.smooth_launch
  fn.restype = ctypes.c_int
  fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_void_p]
  dims_c = (ctypes.c_int * len(dims))(*dims)
  outs_c = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
  err = fn(qpos.data_ptr(), qvel.data_ptr(), itab.data_ptr(),
           ftab.data_ptr(), ctypes.addressof(dims_c),
           ctypes.addressof(outs_c), _build.stream_ptr(qpos))
  _build.check(lib, NAME, err)
  _build.LAUNCHES[NAME] += 1
  res = dict(zip(OUT_KEYS, outs[:len(OUT_KEYS)]))
  res['geom_xpos'] = res['geom_xpos'][:, :tree.ngeom]
  res['geom_xmat'] = res['geom_xmat'][:, :tree.ngeom]
  return res
