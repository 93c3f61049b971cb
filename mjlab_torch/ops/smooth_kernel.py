"""K3: fused smooth stage (kinematics through RNE) in one CUDA kernel.

Hand-written kernel (csrc/smooth.cu) in place of the TPU kernel
mjlab_tpu/ops/smooth_kernel.py:_make_kernel. Its plain version is
physics/smooth_fused.py:plain_all (kinematics -> com_pos -> com_vel -> crb
-> rne). `_Tree` is the static schedule the kernel walks; its `supported`
rule is the model-class gate (one FREE root joint, at most one HINGE or
SLIDE joint on every other body, no mocap bodies).

Model constants: the kernel reads a float table cut from the Model in
segments (bconst, jconst, gconst, sconst, qpos0, armature, and gravity), as
the TPU kernel takes them. A segment whose fields the Model carries with a
leading env axis (per-env domain randomization) goes into a per-env table
of one row an env, which the kernel reads from global memory; the others
go into the shared table, which a block copies into its shared memory. A
Model with no per-env segment launches the kernel's shared-table form
(launches counted as `smooth`), any other its per-env form (`smooth_env`).
Both tables are built once per Model (`_Plan`).

Fit rule: a warp works on one env whose working set lies in the block's
shared memory beside the shared table and the int table, so a model runs
when the library's own `smooth_smem_bytes` (csrc/smooth.cu, the one owner
of the layout) for one env a block is at most the 227 KB a Hopper block may
use; a larger model raises. On the Unitree G1 an env's slice is 13,600 B,
and the tables are 1,092 floats (all shared) and 824 ints.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mjlab_torch.ops import _build
from mjlab_torch.ops import work as _work
from mjlab_torch.physics.types import DisableBit, JointType

NAME = 'smooth'
NAME_PER_ENV = 'smooth_env'  # the launch count of the per-env form
SMEM_LIMIT = _build.SMEM_LIMIT

OUT_KEYS = ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'xanchor', 'xaxis',
            'geom_xpos', 'geom_xmat', 'site_xpos', 'site_xmat',
            'subtree_com', 'cinr', 'cdof', 'cvel', 'cdof_dot', 'qM',
            'qfrc_bias')

# Warps (envs) a block: as many as fit one block's shared memory, up to
# this, and no more than it takes to give every SM a block.
ENVS_PER_BLOCK = 16

# Model fields the kernel's float table is cut from, in the order of its
# segments (bconst: the six body fields; jconst; gconst; sconst; qpos0;
# armature), then opt.gravity. Gravity is always shared: it is no field
# that domain randomization can name, in either package.
FLOAT_TABLE_FIELDS = ('body_pos', 'body_quat', 'body_ipos', 'body_iquat',
                      'body_inertia', 'body_mass', 'jnt_pos', 'jnt_axis',
                      'geom_pos', 'geom_quat', 'site_pos', 'site_quat',
                      'qpos0', 'dof_armature')


class _Tree:
  """Static per-model schedule of the kernel's loops."""

  def __init__(self, s):
    self.nbody = int(s.nbody)
    self.njnt = int(s.njnt)
    self.nv = int(s.nv)
    self.nq = int(s.nq)
    self.ngeom = int(s.ngeom)
    self.nsite = int(s.nsite)
    # bodies by tree depth, the world body excluded (in the kernel's table
    # it is a level of its own, ahead of these); a body's parent sits on
    # the level before its own
    self.levels = [[int(b) for b in level] for level in s.body_levels]
    # parent-before-child order, excluding the world body
    self.order = [b for level in self.levels for b in level]
    self.parent = [int(p) for p in s.body_parentid]
    self.jnt_of_body = [-1] * self.nbody
    for j in range(self.njnt):
      self.jnt_of_body[int(s.jnt_bodyid[j])] = j
    anc = np.asarray(s.ancestor_mask)
    # a body's dofs and its ancestors', root first: the terms of its cvel
    # and cacc in the order a sweep from parent to child adds them
    self.ancestor_dofs = [[int(d) for d in np.nonzero(anc[b] > 0.5)[0]]
                          for b in range(self.nbody)]
    # qM sparsity: for dof i, the j <= i with ancestor_mask[body(i), j]
    self.qm_pairs = [
        [j for j in range(i + 1) if anc[int(s.dof_bodyid[i]), j] > 0.5]
        for i in range(self.nv)]
    # the same as one row of bits per dof, 32 to a word
    mask = np.zeros((self.nv, (self.nv + 31) // 32), np.uint32)
    for i, pairs in enumerate(self.qm_pairs):
      for j in pairs:
        mask[i, j >> 5] |= np.uint32(1 << (j & 31))
    self.gravity_off = bool(s.disableflags & DisableBit.GRAVITY)
    kernel_levels = [[0]] + self.levels
    self.nlevel = len(kernel_levels)
    order = [0] + self.order
    tables = [
        ('order', order),
        ('level_ptr', np.cumsum([0] + [len(v) for v in kernel_levels])),
        # (body, parent) at each position of `order`, for the serial sweeps
        ('sweep', [[b, self.parent[b]] for b in order]),
        ('anc_ptr', np.cumsum([0] + [len(a) for a in self.ancestor_dofs])),
        ('anc_idx', [d for a in self.ancestor_dofs for d in a]),
        ('parent', self.parent),
        ('jnt_of_body', self.jnt_of_body), ('jnt_type', s.jnt_type),
        ('jnt_qposadr', s.jnt_qposadr), ('jnt_dofadr', s.jnt_dofadr),
        ('rootid', s.body_rootid), ('geom_body', s.geom_bodyid),
        ('site_body', s.site_bodyid), ('body_dofadr', s.body_dofadr),
        ('dof_body', s.dof_bodyid),
        ('qm_mask', mask.view(np.int32)),
    ]
    self.int_offsets = {}
    parts = []
    off = 0
    for name, arr in tables:
      arr = np.asarray(arr, np.int32).reshape(-1)
      self.int_offsets[name] = off
      parts.append(arr)
      off += len(arr)
    self.int_table = np.concatenate(parts + [np.zeros(1, np.int32)])
    self._device_tables = {}

  def table(self, name: str) -> np.ndarray:
    """One named part of the int table."""
    names = list(self.int_offsets)
    k = names.index(name)
    end = (self.int_offsets[names[k + 1]] if k + 1 < len(names)
           else len(self.int_table) - 1)
    return self.int_table[self.int_offsets[name]:end]

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


def _table_sources(m) -> list:
  """The tensors the float table is cut from, in FLOAT_TABLE_FIELDS' order,
  then opt.gravity."""
  return [getattr(m, f) for f in FLOAT_TABLE_FIELDS] + [m.opt.gravity]


def _float_tables(sources, nsite: int):
  """The model constants as the kernel reads them: (the shared table, flat;
  the per-env table, (B, floats an env), or None; the offset of every
  segment and of gravity in its own table; the bit mask of the per-env
  segments). A segment is per env where one of its fields carries a
  leading env axis; its shared fields are then repeated in every row."""
  (body_pos, body_quat, body_ipos, body_iquat, body_inertia, body_mass,
   jnt_pos, jnt_axis, geom_pos, geom_quat, site_pos, site_quat, qpos0,
   dof_armature, gravity) = sources
  # segment k is bit k of Dims::env_segs; every part as rows of an entity,
  # (n, k) shared or (B, n, k) per env
  segments = [
      [body_pos, body_quat, body_ipos, body_iquat, body_inertia,
       body_mass[..., None]],
      [jnt_pos, jnt_axis], [geom_pos, geom_quat],
      [site_pos, site_quat] if nsite else [qpos0.new_zeros((1, 7))],
      [qpos0[..., None]], [dof_armature[..., None]]]
  batch = {t.shape[0] for seg in segments for t in seg if t.dim() == 3}
  if len(batch) > 1:
    raise ValueError(f'per-env model fields disagree on the number of envs: '
                     f'{sorted(batch)}')
  B = batch.pop() if batch else 0
  shared, per_env, offsets, mask = [], [], [], 0
  shared_at = env_at = 0
  for k, seg in enumerate(segments):
    if any(t.dim() == 3 for t in seg):
      part = torch.cat([t.expand((B,) + t.shape[-2:]) for t in seg],
                       -1).reshape(B, -1)
      offsets.append(env_at)
      env_at += part.shape[1]
      per_env.append(part)
      mask |= 1 << k
    else:
      part = torch.cat(seg, -1).reshape(-1)
      offsets.append(shared_at)
      shared_at += part.numel()
      shared.append(part)
  offsets.append(shared_at)
  shared.append(gravity)
  etab = torch.cat(per_env, -1).contiguous() if per_env else None
  return torch.cat(shared), etab, offsets, mask


def _table_key(sources) -> tuple:
  """Identity and version of the tensors the float table is cut from: a
  tensor put in a field's place, or one written in place, changes it."""
  return tuple((id(t), t._version) for t in sources)


class _Plan:
  """What a launch needs of one Model, built once: the shared and the
  per-env float table on the model's device, the argument block (Dims of
  csrc/smooth.cu) and the output shapes. The Model carries it as
  `_smooth_plan`."""

  def __init__(self, m):
    tree = tree_of(m.stat)
    self.sources = _table_sources(m)  # kept alive: their ids are the key
    self.key = _table_key(self.sources)
    self.ftab, self.etab, foffs, env_segs = _float_tables(self.sources,
                                                          tree.nsite)
    # envs of the per-env table; 0: the shared-table form
    self.env_batch = 0 if self.etab is None else self.etab.shape[0]
    etab_len = 0 if self.etab is None else self.etab.shape[1]
    self.itab = tree.device_table(m.device)
    nb, nj, nv = tree.nbody, tree.njnt, tree.nv
    nj1, ng1, ns1 = max(nj, 1), max(tree.ngeom, 1), max(tree.nsite, 1)
    dims = [0, nb, nj, nv, tree.nq, tree.ngeom, tree.nsite, tree.nlevel,
            int(tree.gravity_off), nj1, ng1, ns1, len(tree.int_table),
            self.ftab.numel(), etab_len, env_segs] + list(
                tree.int_offsets.values()) + foffs
    self.dims = (ctypes.c_int * len(dims))(*dims)  # dims[0]: the batch
    self.shapes = [(nb, 3), (nb, 4), (nb, 3, 3), (nb, 3), (nb, 3, 3),
                   (nj1, 3), (nj1, 3), (ng1, 3), (ng1, 3, 3), (ns1, 3),
                   (ns1, 3, 3), (nb, 3), (nb, 6, 6), (nv, 6), (nb, 6),
                   (nv, 6), (nv, nv), (nv,)]
    self.sizes = [int(np.prod(sh)) for sh in self.shapes]
    self.ngeom = tree.ngeom
    self.fits = {}  # envs a block asked for -> envs a block


def plan_of(m) -> _Plan:
  """The Model's launch plan. It is rebuilt when a field of the float table
  was replaced (`m.replace(...)` makes a new Model, which has no plan yet,
  as `randomize_field` does; assigning to a field changes its identity) or
  written in place (the tensor's version counter), so no launch sees a
  stale table."""
  plan = m.__dict__.get('_smooth_plan')
  if plan is None or plan.key != _table_key(_table_sources(m)):
    plan = _Plan(m)
    m.__dict__['_smooth_plan'] = plan
  return plan


@functools.cache
def _entry_points(lib):
  """The library's launch and layout functions, their C signatures set
  once."""
  ptr, c_int = ctypes.c_void_p, ctypes.c_int
  lib.smooth_launch.restype = c_int
  lib.smooth_launch.argtypes = [ptr] * 7 + [c_int, ptr]
  lib.smooth_smem_bytes.restype = ctypes.c_size_t
  lib.smooth_smem_bytes.argtypes = [ptr, c_int]
  for count in (lib.smooth_dims_count, lib.smooth_num_outputs):
    count.restype, count.argtypes = c_int, []
  lib.smooth_num_regs.restype, lib.smooth_num_regs.argtypes = c_int, [c_int]
  return lib.smooth_launch, lib.smooth_smem_bytes


def smooth_num_regs(per_env: bool) -> int:
  """Registers a thread of the kernel's shared-table or per-env form uses,
  as the CUDA runtime reports them (builds the library on first use)."""
  lib = _build.library(NAME)
  _entry_points(lib)
  n = lib.smooth_num_regs(int(per_env))
  if n < 0:
    _build.check(lib, NAME, -n)
  return n


@functools.cache
def _sm_count(device) -> int:
  return torch.cuda.get_device_properties(device).multi_processor_count


def smooth_smem_bytes(m, envs_per_block: int) -> int:
  """Shared memory one block of the kernel needs for Model `m`, as the
  library reports it (builds the library on first use)."""
  _, smem_fn = _entry_points(_build.library(NAME))
  return int(smem_fn(ctypes.addressof(plan_of(m).dims), envs_per_block))


def _fit(lib, plan, envs_per_block: int) -> int:
  """The envs a block takes: the number asked for, or the most below it
  whose shared memory a block may use. Raises where one does not fit."""
  if envs_per_block not in plan.fits:
    if (lib.smooth_dims_count() != len(plan.dims)
        or lib.smooth_num_outputs() != len(plan.shapes)):
      raise RuntimeError('smooth kernel argument layout mismatch')
    _, smem_fn = _entry_points(lib)
    need = lambda n: smem_fn(ctypes.addressof(plan.dims), n)
    epb = min(max(envs_per_block, 1), 32)
    while epb > 1 and need(epb) > SMEM_LIMIT:
      epb -= 1
    if need(epb) > SMEM_LIMIT:
      raise ValueError(
          f'smooth kernel needs {need(epb)} bytes of shared memory for one '
          f'env a block, over the {SMEM_LIMIT} a block may use')
    plan.fits[envs_per_block] = epb
  return plan.fits[envs_per_block]


def smooth_fused_cuda(m, qpos: torch.Tensor, qvel: torch.Tensor, *,
                      envs_per_block: int = None) -> dict:
  """Kernel path: qpos (B, nq), qvel (B, nv), float32 CUDA. Returns the
  smooth-stage outputs, batched on axis 0, keyed as Data fields; they are
  views of one allocation. `envs_per_block` overrides the module's choice.
  Fewer envs go into a block when the number asked for does not fit its
  shared memory; a model of which one env does not fit raises. A Model
  with per-env fields of the float table launches the per-env form, whose
  envs must be the batch's."""
  s = m.stat
  B = qpos.shape[0]
  _build.require(qpos, 'qpos', (B, s.nq))
  _build.require(qvel, 'qvel', (B, s.nv))
  if m.dtype != torch.float32 or m.device != qpos.device:
    raise TypeError('model must be float32 on the data device')
  lib = _build.library(NAME)
  launch, _ = _entry_points(lib)
  plan = plan_of(m)
  if plan.env_batch and plan.env_batch != B:
    raise ValueError(f'the model carries per-env fields of {plan.env_batch} '
                     f'envs, the batch has {B}')
  if envs_per_block is None:
    envs_per_block = min(ENVS_PER_BLOCK, max(-(-B // _sm_count(qpos.device)),
                                             1))
  epb = _fit(lib, plan, int(envs_per_block))
  plan.dims[0] = B
  buf = torch.empty(B * sum(plan.sizes), dtype=qpos.dtype, device=qpos.device)
  outs = [o.view((B,) + sh) for o, sh in zip(
      buf.split([B * n for n in plan.sizes]), plan.shapes)]
  outs_c = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
  err = launch(qpos.data_ptr(), qvel.data_ptr(), plan.itab.data_ptr(),
               plan.ftab.data_ptr(),
               None if plan.etab is None else plan.etab.data_ptr(),
               ctypes.addressof(plan.dims), ctypes.addressof(outs_c), epb,
               _build.stream_ptr(qpos))
  _build.check(lib, NAME, err)
  name = NAME if plan.etab is None else NAME_PER_ENV
  _build.LAUNCHES[name] += 1
  res = dict(zip(OUT_KEYS, outs))
  if not plan.ngeom:
    res['geom_xpos'] = res['geom_xpos'][:, :0]
    res['geom_xmat'] = res['geom_xmat'][:, :0]
  if _build.COUNTER is not None:
    _build.COUNTER.charge(name, lambda: _work.k3_work(m, qpos, qvel, res))
  return res
