"""Constraint row assembly (equality, dof friction, joint and tendon
limits, contacts), batched.

Counterpart of mjlab_tpu/physics/constraint.py. The row layout is static
and in MuJoCo's order: the equality rows (connect 3, weld 6, joint 1, each
bilateral), a friction-loss row for every dof (J = I, masked by
frictionloss > 0), a limit row for every limited hinge/slide joint
(one-hot J), a limit row for every limited tendon (J = +-ten_J), and the
contact block, which holds either the rows of every candidate contact slot
or, with compaction (large pair tables), the rows of the deepest
candidates chosen per env from two static slot pools (frictional and
frictionless). Inactive rows carry zero D, so the solver's shapes never
change.

The compacted pools' rows of a pyramidal model are built on the card by
kernel K4 (ops/contact_rows.py) from the selected slots; its plain version
is `contacts_compacted_plain`, which builds them everywhere else (the CPU,
an elliptic model). `make_efc` counts which of the two ran
(`contact_rows_kernel`, utils/tracing.py).

Pyramidal cone: a slot of condim d has 2 (d - 1) rows (Jn +- mu_i T_i),
one when d == 1, all in the dense `c_*` block. Elliptic cone: a
frictional slot has d rows (normal, then its friction axes) in the
structured `x_*` block, one entry per slot, which the solver's cone cost
couples; frictionless slots keep one normal row in the `c_*` block.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mjlab_torch.ops import contact_rows as _contact_rows
from mjlab_torch.physics import math as pmath
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.tables import table
from mjlab_torch.physics.types import (
    ConeType,
    Data,
    DisableBit,
    JointType,
    Model,
    ModelStatic,
)
from mjlab_torch.utils import tracing

_MINIMP = 0.0001
_MAXIMP = 0.9999
_MINVAL = 1e-15


_EQ_CONNECT, _EQ_WELD, _EQ_JOINT = 0, 1, 2  # mjtEq
_EQ_ROWS = {_EQ_CONNECT: 3, _EQ_WELD: 6, _EQ_JOINT: 1}


def equality_rows_count(stat: ModelStatic) -> int:
  return int(sum(_EQ_ROWS[int(t)] for t in stat.eq_type[:stat.neq])
             ) if stat.neq else 0


@dataclasses.dataclass(frozen=True)
class EfcLayout:
  """Row order matches MuJoCo's efc arrays:
  [equality | friction | joint limits | tendon limits | contacts]."""
  nefc: int
  ne: int  # equality rows, [0, ne)
  nf: int  # friction rows, one a dof, [ne, ne + nf)
  limit_jnt: np.ndarray  # joint ids with limit rows
  con_base: np.ndarray  # first row of each contact slot (or pool slot)
  limit_ten: np.ndarray  # tendon ids with limit rows

  @property
  def nl(self) -> int:
    return len(self.limit_jnt)

  @property
  def nlt(self) -> int:
    return len(self.limit_ten)

  @property
  def con_row0(self) -> int:
    """The first contact row."""
    return self.ne + self.nf + self.nl + self.nlt

  @property
  def ncr(self) -> int:
    """Total dense contact rows."""
    return self.nefc - self.con_row0


def elliptic_dmax(stat: ModelStatic) -> int:
  """The largest condim of the frictional contact slots of an elliptic
  model; 0 for a pyramidal model or one without frictional slots.
  Nonzero: make_efc emits the structured elliptic `x_*` block."""
  if stat.cone != int(ConeType.ELLIPTIC) or not stat.pairs.ncon_max:
    return 0
  dm = int(np.max(stat.con_dim[:stat.pairs.ncon_max]))
  return dm if dm > 1 else 0


@functools.lru_cache(maxsize=32)
def efc_layout(stat: ModelStatic) -> EfcLayout:
  ne = equality_rows_count(stat)
  nf = stat.nv
  limit_jnt = np.nonzero(
      stat.jnt_limited &
      np.isin(stat.jnt_type, (int(JointType.HINGE), int(JointType.SLIDE))))[0]
  limit_ten = (np.nonzero(stat.ten_limited[:stat.ntendon])[0]
               if stat.ntendon else np.zeros(0, np.int64))
  ell = stat.cone == int(ConeType.ELLIPTIC)
  if stat.ncon_cap or stat.ncon_cap1:
    # compacted: ncon_cap frictional slots of 2*(maxdim-1) rows (elliptic:
    # maxdim rows), then ncon_cap1 frictionless slots of one row
    dm = elliptic_dmax(stat)
    k_rows = dm if dm else 2 * max(int(stat.con_dim.max()) - 1, 1)
    con_rows = np.concatenate([np.full(stat.ncon_cap, k_rows, np.int32),
                               np.ones(stat.ncon_cap1, np.int32)])
  else:
    # every candidate slot: 1 row (condim 1), else 2*(condim-1) rows
    # (elliptic: condim rows)
    dims = np.asarray(stat.con_dim[:stat.pairs.ncon_max], np.int32)
    con_rows = np.where(dims == 1, 1,
                        dims if ell else 2 * (dims - 1)).astype(np.int32)
  base0 = ne + nf + len(limit_jnt) + len(limit_ten)
  con_base = (base0 + np.cumsum(con_rows) - con_rows).astype(np.int32)
  return EfcLayout(nefc=base0 + int(con_rows.sum()), ne=ne, nf=nf,
                   limit_jnt=limit_jnt, con_base=con_base,
                   limit_ten=limit_ten)


def limit_dofadr(stat: ModelStatic) -> np.ndarray:
  """Static dof address of each limit row (at least length 1)."""
  lay = efc_layout(stat)
  if lay.nl == 0:
    return np.zeros(1, np.int32)
  return stat.jnt_dofadr[lay.limit_jnt].astype(np.int32)


def compaction_slot_pools(stat: ModelStatic):
  """Candidate-slot ids of the two pools: frictional (condim > 1) and
  frictionless (condim == 1)."""
  dims = np.asarray(stat.con_dim[:stat.pairs.ncon_max])
  return (np.nonzero(dims > 1)[0].astype(np.int32),
          np.nonzero(dims == 1)[0].astype(np.int32))


@functools.lru_cache(maxsize=32)
def elliptic_row_maps(stat: ModelStatic):
  """Static dense efc rows of an elliptic model's blocks: x_rows (NX, DM),
  where the axes beyond a slot's condim map to row nefc (dropped), and
  c1_rows, the rows of the frictionless slots (or pool slots)."""
  lay = efc_layout(stat)
  DM = elliptic_dmax(stat)
  if stat.ncon_cap or stat.ncon_cap1:
    K3, K1 = stat.ncon_cap, stat.ncon_cap1
    x_rows = lay.con_base[:K3, None] + np.arange(DM)[None, :]
    return x_rows.astype(np.int64), lay.con_base[K3:K3 + K1].astype(np.int64)
  sl3, sl1 = compaction_slot_pools(stat)
  dims = np.asarray(stat.con_dim[:stat.pairs.ncon_max])
  x_rows = lay.con_base[sl3][:, None] + np.arange(DM)[None, :]
  invalid = np.arange(DM)[None, :] >= dims[sl3][:, None]
  x_rows = np.where(invalid, lay.nefc, x_rows)
  return x_rows.astype(np.int64), lay.con_base[sl1].astype(np.int64)


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
  """MuJoCo constraint impedance sigmoid d(r)."""
  dmin = solimp[..., 0].clamp(_MINIMP, _MAXIMP)
  dmax = solimp[..., 1].clamp(_MINIMP, _MAXIMP)
  width = solimp[..., 2].clamp_min(_MINVAL)
  mid = solimp[..., 3].clamp(_MINIMP, _MAXIMP)
  power = solimp[..., 4].clamp_min(1.0)
  x = (pos.abs() / width).clamp(0.0, 1.0)
  y_lo = mid * torch.pow(x / mid.clamp_min(_MINVAL), power)
  y_hi = 1.0 - (1.0 - mid) * torch.pow(
      (1.0 - x) / (1.0 - mid).clamp_min(_MINVAL), power)
  y = torch.where(x <= mid, y_lo, y_hi)
  y = torch.where(power <= 1.0, x, y)
  return (dmin + y * (dmax - dmin)).clamp(_MINIMP, _MAXIMP)


def _kbi(solref, solimp, pos, timestep, refsafe: bool):
  """Reference-acceleration coefficients (b, k) and impedance."""
  imp = _impedance(solimp, pos)
  dmax = solimp[..., 1].clamp(_MINIMP, _MAXIMP)
  timeconst = solref[..., 0]
  dampratio = solref[..., 1]
  if refsafe:
    timeconst = torch.maximum(timeconst, 2.0 * timestep)
  b_std = 2.0 / (dmax * timeconst.clamp_min(_MINVAL))
  k_std = 1.0 / (dmax * dmax * timeconst * timeconst * dampratio
                 * dampratio).clamp_min(_MINVAL)
  direct = (solref[..., 0] <= 0) | (solref[..., 1] <= 0)
  b = torch.where(direct, -solref[..., 1] / dmax, b_std)
  k = torch.where(direct, -solref[..., 0] / (dmax * dmax), k_std)
  return b, k, imp


@functools.lru_cache(maxsize=32)
def _pool_static(stat: ModelStatic, slots_key: tuple):
  """Per-slot static data of one pool: signed ancestor delta (np, nv),
  body ids and root body ids of both sides."""
  slots = np.asarray(slots_key, np.int64)
  b1 = stat.geom_bodyid[np.asarray(stat.con_geom1)[slots]]
  b2 = stat.geom_bodyid[np.asarray(stat.con_geom2)[slots]]
  anc = np.asarray(stat.ancestor_mask)
  return (anc[b2] - anc[b1], b1, b2, stat.body_rootid[b1],
          stat.body_rootid[b2])


def deepest(p_pool: torch.Tensor, K: int) -> torch.Tensor:
  """(B, K) positions in a pool of its K deepest candidates (p_pool (B,
  np) their distances past the margin); ties take the lower slot first,
  as the JAX engine's top_k."""
  return torch.sort(-p_pool, dim=-1, descending=True, stable=True)[1][:, :K]


def _selected_contact_data(m: Model, d: Data, slots: np.ndarray, K: int):
  """Per env, the K deepest candidate slots of a pool (ties: lower slot
  first, as the JAX engine's top_k) and their contact data."""
  s = m.stat
  dev = d.qpos.device
  con = d.contact
  anc_delta, b1, b2, root1, root2 = _pool_static(
      s, tuple(int(x) for x in slots))
  sl = _ix(slots, dev)
  p_pool = (con.dist - con.includemargin)[:, sl]  # (B, np)
  sel = deepest(p_pool, K)
  slot = sl[sel]  # (B, K) candidate slot ids

  def take(x):  # (B, ncon, ...) -> (B, K, ...)
    idx = slot.reshape(slot.shape + (1,) * (x.dim() - 2)).expand(
        slot.shape + x.shape[2:])
    return torch.gather(x, 1, idx)

  p = torch.gather(p_pool, 1, sel)
  anc_t = table(anc_delta, d.qpos.dtype, dev)
  croot1 = torch.gather(d.subtree_com, 1, _ix(root1, dev)[sel][..., None]
                        .expand(sel.shape + (3,)))
  croot2 = torch.gather(d.subtree_com, 1, _ix(root2, dev)[sel][..., None]
                        .expand(sel.shape + (3,)))
  invw_all = (m.body_invweight0[_ix(b1, dev), 0]
              + m.body_invweight0[_ix(b2, dev), 0])
  dim = table(s.con_dim, torch.int32, dev)[slot]
  return (p, take(con.pos), take(con.frame), take(con.friction),
          take(con.solref), take(con.solimp), croot1, croot2,
          invw_all[sel], anc_t[sel], dim)


def _pool_jacobians(d: Data, pos_w, frame, croot1, croot2, ancd,
                    with_axes: bool):
  """Contact-frame Jacobian rows of the selected slots. The two-body
  difference folds into the signed ancestor delta; dofs on side 2 use its
  root com, dofs on side 1 theirs (shared ancestors cancel)."""
  cdof_ang = d.cdof[:, None, :, :3]  # (B, 1, nv, 3)
  cdof_lin = d.cdof[:, None, :, 3:]
  rel1 = (pos_w - croot1)[:, :, None, :]
  rel2 = (pos_w - croot2)[:, :, None, :]
  rel = torch.where((ancd > 0)[..., None], rel2, rel1)  # (B, K, nv, 3)
  jt = (cdof_lin + pmath.cross(cdof_ang, rel)) * ancd[..., None]
  if not with_axes:
    n_row = torch.einsum('bcx,bcvx->bcv', frame[:, :, 0], jt)
    return n_row, None, torch.einsum('bcv,bv->bc', n_row, d.qvel), None
  jr = cdof_ang * ancd[..., None]
  jt_f = torch.einsum('bcfx,bcvx->bcfv', frame, jt)  # (B, K, 3, nv)
  jr_f = torch.einsum('bcfx,bcvx->bcfv', frame, jr)
  return (jt_f, jr_f, torch.einsum('bcfv,bv->bcf', jt_f, d.qvel),
          torch.einsum('bcfv,bv->bcf', jr_f, d.qvel))


def _elliptic_block(p, jt_f, jr_f, vel_t, vel_r, friction, solref, solimp,
                    invw, dim, impratio, ts, refsafe: bool, DM: int) -> dict:
  """The structured elliptic contact block, one entry per frictional slot
  (leading axes (B, NX)), as the JAX engine builds it from MuJoCo's
  elliptic-cone model: cone coefficient mu = friction_0 / sqrt(impratio),
  friction-row D_j = D_normal * impratio * (friction_j / friction_0)^2,
  friction-row aref = -b vel_j; the normal row as in the pyramidal case.

    x_J (B, NX, DM, nv) rows [normal, t1, t2, torsional, r1, r2]
    x_D, x_aref (B, NX, DM): zero beyond each slot's condim
    x_mu (B, NX); x_fr (B, NX, DM-1) the friction (zero beyond condim)
    x_active, x_pos (B, NX)"""
  act = p < 0
  b_c, k_c, imp = _kbi(solref, solimp, p, ts, refsafe)
  D_n = 1.0 / ((1.0 - imp) / imp * invw).clamp_min(_MINVAL)
  A = DM - 1
  zero = p.new_zeros(())
  real_axis = (torch.arange(A, device=p.device)
               < (dim[..., None] - 1))  # (B or 1, NX, A)
  fr = torch.where(real_axis, friction[..., :A], zero)
  fr0 = friction[..., 0].clamp_min(_MINVAL)
  mu = fr0 / torch.sqrt(impratio)
  D_f = torch.where(real_axis,
                    D_n[..., None] * impratio * (fr / fr0[..., None]) ** 2,
                    zero)
  axes = torch.cat([jt_f[:, :, 1:3], jr_f], dim=2)[:, :, :A]
  vels = torch.cat([vel_t[..., 1:3], vel_r], dim=-1)[..., :A]
  aref_n = -b_c * vel_t[..., 0] - k_c * imp * p
  aref_f = torch.where(real_axis, -b_c[..., None] * vels, zero)
  x_D = torch.cat([D_n[..., None], D_f], dim=-1)
  return dict(
      x_J=torch.cat([jt_f[:, :, :1], axes], dim=2),
      x_D=torch.where(act[..., None], x_D, zero),
      x_aref=torch.cat([aref_n[..., None], aref_f], dim=-1),
      x_mu=mu, x_fr=fr, x_active=act, x_pos=p)


def elliptic_block_empty(stat: ModelStatic) -> bool:
  """Whether `make_efc` gives an elliptic model `_empty_elliptic`'s block:
  no contact rows, contacts disabled, or a compacted pool of no frictional
  slot."""
  return bool(not efc_layout(stat).ncr
              or stat.disableflags & DisableBit.CONTACT
              or (stat.ncon_cap1 and not stat.ncon_cap))


def _empty_elliptic(B: int, nv: int, DM: int, dtype, dev) -> dict:
  """A one-slot elliptic block with nothing active (contacts disabled)."""
  z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)
  return dict(x_J=z(1, DM, nv), x_D=z(1, DM), x_aref=z(1, DM), x_mu=z(1),
              x_fr=z(1, DM - 1),
              x_active=torch.zeros((B, 1), dtype=torch.bool, device=dev),
              x_pos=z(1))


def contacts_compacted_plain(m: Model, d: Data, ts, refsafe: bool):
  """Contact rows of the deepest candidate slots of each pool: uniform
  pyramidal blocks of 2*(maxdim-1) rows for frictional slots (elliptic:
  the x block of those slots), one normal row for frictionless ones.
  Returns the c block's five tensors and the x block or None. The plain
  version of K4 (ops/contact_rows.py)."""
  s = m.stat
  B = d.qpos.shape[0]
  K3, K1 = s.ncon_cap, s.ncon_cap1
  A = max(int(s.con_dim.max()) - 1, 1)
  slots3, slots1 = compaction_slot_pools(s)
  impratio = m.opt.impratio
  ell_dm = elliptic_dmax(s)
  blocks, x_block = [], None

  if K3 and ell_dm:
    (p, pos_w, frame, friction, solref, solimp, croot1, croot2, invw,
     ancd, dim) = _selected_contact_data(m, d, slots3, K3)
    jt_f, jr_f, vel_t, vel_r = _pool_jacobians(
        d, pos_w, frame, croot1, croot2, ancd, True)
    x_block = _elliptic_block(p, jt_f, jr_f, vel_t, vel_r, friction, solref,
                              solimp, invw, dim, impratio, ts, refsafe,
                              ell_dm)
  elif K3:
    (p, pos_w, frame, friction, solref, solimp, croot1, croot2, invw,
     ancd, dim) = _selected_contact_data(m, d, slots3, K3)
    act = p < 0
    jt_f, jr_f, vel_t, vel_r = _pool_jacobians(
        d, pos_w, frame, croot1, croot2, ancd, True)
    jn, vn = jt_f[:, :, 0], vel_t[:, :, 0]
    axes = torch.cat([jt_f[:, :, 1:3], jr_f], dim=2)[:, :, :A]
    vels = torch.cat([vel_t[:, :, 1:3], vel_r], dim=2)[:, :, :A]
    b_c, k_c, imp = _kbi(solref, solimp, p, ts, refsafe)
    real_axis = (torch.arange(A, device=p.device)[None, None, :]
                 < (dim[..., None] - 1))
    mu = torch.where(real_axis, friction[..., :A],
                     torch.zeros_like(friction[..., :A]))
    row_active = real_axis & act[..., None]
    # diagApprox uses the first friction coefficient for every row
    mu0 = friction[..., 0:1]
    dA = (invw[..., None] * (1.0 + mu0 * mu0) * 2.0 * mu0 * mu0
          / impratio).expand(mu.shape)
    imp_e = imp[..., None]
    D_axis = 1.0 / ((1.0 - imp_e) / imp_e * dA).clamp_min(_MINVAL)
    signs = table(np.array([1.0, -1.0]), p.dtype, p.device)
    Jrows = (jn[:, :, None, None, :]
             + signs[:, None] * (mu[..., None] * axes)[:, :, :, None, :])
    vrows = vn[:, :, None, None] + signs * (mu * vels)[..., None]
    aref_rows = (-b_c[..., None, None] * vrows
                 - (k_c * imp * p)[..., None, None])
    rows = K3 * A * 2
    blocks.append((
        Jrows.reshape(B, rows, s.nv),
        D_axis[..., None].expand(B, K3, A, 2).reshape(B, rows),
        aref_rows.reshape(B, rows),
        row_active[..., None].expand(B, K3, A, 2).reshape(B, rows),
        p[..., None, None].expand(B, K3, A, 2).reshape(B, rows)))

  if K1:
    (p, pos_w, frame, friction, solref, solimp, croot1, croot2, invw,
     ancd, dim) = _selected_contact_data(m, d, slots1, K1)
    jn, _, vn, _ = _pool_jacobians(d, pos_w, frame, croot1, croot2, ancd,
                                   False)
    b_c, k_c, imp = _kbi(solref, solimp, p, ts, refsafe)
    r = ((1.0 - imp) / imp * invw).clamp_min(_MINVAL)
    blocks.append((jn, 1.0 / r, -b_c * vn - k_c * imp * p, p < 0, p))

  if not blocks:  # elliptic without a frictionless pool: a dummy row
    blocks.append(_no_rows(B, 1, s.nv, d.qpos.dtype, d.qpos.device))
  return tuple(torch.cat([blk[i] for blk in blocks], dim=1)
               for i in range(5)), x_block


@functools.lru_cache(maxsize=32)
def _pool_tables(stat: ModelStatic):
  """K4's static pool entries, the frictional pool's first: (tab (np, 5)
  int32 of slot, body1, body2, root1, root2; dim (np,) int32, the slots'
  condim; ancd (np, nv) int8, the signed ancestor delta; np3, the
  frictional pool's entries)."""
  pools = compaction_slot_pools(stat)
  parts = [_pool_static(stat, tuple(int(x) for x in sl)) for sl in pools]
  slots = np.concatenate(pools)
  tab = np.stack([slots] + [np.concatenate([p[i] for p in parts])
                            for i in range(1, 5)], axis=1)
  ancd = np.concatenate([p[0] for p in parts])
  return (tab.astype(np.int32), np.asarray(stat.con_dim)[slots].astype(
      np.int32), ancd.astype(np.int8), len(pools[0]))


def _pyramid_axes(stat: ModelStatic) -> int:
  """Friction axes A of a compacted frictional slot: 2 A pyramid rows."""
  return max(int(stat.con_dim.max()) - 1, 1)


def contact_rows_takes(m: Model, d: Data) -> bool:
  """Whether K4 builds the compacted pools' rows: a float32 batch on CUDA
  of a pyramidal model that compacts, whose shapes the kernel takes."""
  s = m.stat
  if (d.qpos.device.type != 'cuda' or d.qpos.dtype != torch.float32
      or s.cone == int(ConeType.ELLIPTIC)
      or not (s.ncon_cap or s.ncon_cap1)):
    return False
  sl3, sl1 = compaction_slot_pools(s)
  return (len(sl3) >= s.ncon_cap and len(sl1) >= s.ncon_cap1
          and _contact_rows.fits(s.nv, s.ncon_cap, s.ncon_cap1,
                                 _pyramid_axes(s)))


def _contacts_kernel(m: Model, d: Data, ts, refsafe: bool):
  """`contacts_compacted_plain`'s c block by K4: the same selection of
  each pool's deepest slots, then one kernel for every row."""
  s = m.stat
  con = d.contact
  dev = d.qpos.device
  tab, dim, ancd, np3 = _pool_tables(s)
  pdist = con.dist - con.includemargin

  def select(slots, K):
    if not K:
      return torch.empty((pdist.shape[0], 0), dtype=torch.long, device=dev)
    return deepest(pdist[:, _ix(slots, dev)], K)

  sl3, sl1 = compaction_slot_pools(s)
  return _contact_rows.contact_rows_cuda(
      pdist, select(sl3, s.ncon_cap), select(sl1, s.ncon_cap1), con.pos,
      con.frame, con.friction, con.solref, con.solimp, d.cdof,
      d.subtree_com, d.qvel, m.body_invweight0, ts, m.opt.impratio,
      table(tab, torch.int32, dev), table(dim, torch.int32, dev),
      table(ancd, torch.int8, dev), np3=np3, A=_pyramid_axes(s),
      refsafe=refsafe), None


def _no_rows(B: int, n: int, nv: int, dtype, dev):
  """(J, D, aref, active, pos) of n contact rows with nothing active."""
  z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)
  return (z(n, nv), z(n), z(n),
          torch.zeros((B, n), dtype=torch.bool, device=dev), z(n))


def _contacts_all(m: Model, d: Data, ts, refsafe: bool):
  """Contact rows of every candidate slot, grouped by condim: one normal
  row (condim 1) or the pyramid (Jn +- mu_i T_i) rows; on an elliptic
  model, the frictional slots' x block instead of their pyramids.
  Returns the c block's five tensors and the x block or None."""
  s = m.stat
  lay = efc_layout(s)
  dev, dtype = d.qpos.device, d.qpos.dtype
  B = d.qpos.shape[0]
  nv, ncr, ncon = s.nv, lay.ncr, s.pairs.ncon_max
  con = d.contact
  anc = table(s.ancestor_mask, dtype, dev)
  b1 = s.geom_bodyid[np.asarray(s.con_geom1[:ncon])]
  b2 = s.geom_bodyid[np.asarray(s.con_geom2[:ncon])]
  cdof_ang = d.cdof[:, None, :, :3]
  cdof_lin = d.cdof[:, None, :, 3:]

  def point_jac(body):
    croot = d.subtree_com[:, _ix(s.body_rootid[body], dev)]
    rel = (con.pos[:, :ncon] - croot)[:, :, None, :]
    col = cdof_lin + pmath.cross(cdof_ang, rel)
    return col * anc[_ix(body, dev)][None, :, :, None]

  jt = point_jac(b2) - point_jac(b1)  # (B, ncon, nv, 3)
  jr = cdof_ang * (anc[_ix(b2, dev)] - anc[_ix(b1, dev)])[None, :, :, None]
  frame = con.frame[:, :ncon]
  jt_f = torch.einsum('bcfx,bcvx->bcfv', frame, jt)
  jr_f = torch.einsum('bcfx,bcvx->bcfv', frame, jr)
  vel_t = torch.einsum('bcfv,bv->bcf', jt_f, d.qvel)
  vel_r = torch.einsum('bcfv,bv->bcf', jr_f, d.qvel)
  p = (con.dist - con.includemargin)[:, :ncon]
  act = p < 0
  b, k, imp = _kbi(con.solref[:, :ncon], con.solimp[:, :ncon], p, ts,
                   refsafe)
  invw = (m.body_invweight0[_ix(b1, dev), 0]
          + m.body_invweight0[_ix(b2, dev), 0])
  friction = con.friction[:, :ncon]

  ell_dm = elliptic_dmax(s)
  if ell_dm:
    sl3_np, sl1_np = compaction_slot_pools(s)
    sl3, sl1 = _ix(sl3_np, dev), _ix(sl1_np, dev)
    x_block = _elliptic_block(
        p[:, sl3], jt_f[:, sl3], jr_f[:, sl3], vel_t[:, sl3], vel_r[:, sl3],
        friction[:, sl3], con.solref[:, sl3], con.solimp[:, sl3],
        invw[sl3], table(s.con_dim[sl3_np], torch.int32, dev),
        m.opt.impratio, ts, refsafe, ell_dm)
    if not len(sl1_np):
      return _no_rows(B, 1, nv, dtype, dev), x_block
    imps, ps = imp[:, sl1], p[:, sl1]
    r = ((1.0 - imps) / imps * invw[sl1]).clamp_min(_MINVAL)
    return (jt_f[:, sl1, 0], 1.0 / r,
            -b[:, sl1] * vel_t[:, sl1, 0] - k[:, sl1] * imps * ps,
            act[:, sl1], ps), x_block

  c_J = torch.zeros((B, ncr, nv), dtype=dtype, device=dev)
  c_D = torch.zeros((B, ncr), dtype=dtype, device=dev)
  c_aref = torch.zeros_like(c_D)
  c_pos = torch.zeros_like(c_D)
  c_active = torch.zeros((B, ncr), dtype=torch.bool, device=dev)
  row0 = lay.con_row0
  for dim in sorted(set(int(x) for x in s.con_dim[:ncon])):
    sl_np = np.nonzero(s.con_dim[:ncon] == dim)[0]
    sl = _ix(sl_np, dev)
    nsl = len(sl_np)
    kr = 1 if dim == 1 else 2 * (dim - 1)
    rows = _ix((lay.con_base[sl_np][:, None] - row0
                + np.arange(kr)[None, :]).ravel(), dev)
    ps, imps = p[:, sl], imp[:, sl]
    if dim == 1:
      r = ((1.0 - imps) / imps * invw[sl]).clamp_min(_MINVAL)
      c_J[:, rows] = jt_f[:, sl, 0]
      c_D[:, rows] = 1.0 / r
      c_aref[:, rows] = -b[:, sl] * vel_t[:, sl, 0] - k[:, sl] * imps * ps
    else:
      axes = torch.cat([jt_f[:, sl, 1:min(dim, 3)],
                        jr_f[:, sl, :max(dim - 3, 0)]], 2)
      vels = torch.cat([vel_t[:, sl, 1:min(dim, 3)],
                        vel_r[:, sl, :max(dim - 3, 0)]], 2)
      mu = friction[:, sl, :dim - 1]
      signs = table(np.array([1.0, -1.0]), dtype, dev)
      Jrows = (jt_f[:, sl, 0][:, :, None, None, :]
               + signs[:, None] * (mu[..., None] * axes)[:, :, :, None, :])
      vrows = (vel_t[:, sl, 0][..., None, None]
               + signs * (mu * vels)[..., None])
      # diagApprox uses the first friction coefficient for every row
      mu0 = friction[:, sl, 0:1]
      dA = (invw[sl][:, None] * (1.0 + mu0 * mu0) * 2.0 * mu0 * mu0
            / m.opt.impratio).expand(mu.shape)
      imp_e = imps[..., None]
      r = ((1.0 - imp_e) / imp_e * dA).clamp_min(_MINVAL)
      c_J[:, rows] = Jrows.reshape(B, nsl * kr, nv)
      c_D[:, rows] = (1.0 / r)[..., None].expand(B, nsl, dim - 1,
                                                 2).reshape(B, nsl * kr)
      c_aref[:, rows] = (-b[:, sl, None, None] * vrows
                         - (k[:, sl] * imps * ps)[..., None, None]
                         ).reshape(B, nsl * kr)
    c_pos[:, rows] = ps.repeat_interleave(kr, dim=1)
    c_active[:, rows] = act[:, sl].repeat_interleave(kr, dim=1)
  return (c_J, c_D, c_aref, c_active, c_pos), None


def _rot(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """R v for R (B, 3, 3) and v (3,) or per env (B, 3)."""
  return (R * v[..., None, :]).sum(-1)


def _body_point_jac(m: Model, d: Data, body: int, point: torch.Tensor):
  """(B, 3, nv) translational Jacobian of the world point (B, 3) on body."""
  s = m.stat
  anc = table(s.ancestor_mask[body], d.qpos.dtype, d.qpos.device)
  croot = d.subtree_com[:, int(s.body_rootid[body])]
  col = d.cdof[..., 3:] + pmath.cross(d.cdof[..., :3],
                                      (point - croot)[:, None, :])
  return (col * anc[:, None]).transpose(1, 2)


def _jdot_qvel(m: Model, d: Data) -> torch.Tensor:
  """J_dot qvel of the connect and weld rows (B, rows), in closed form:
  the second derivative of their residuals along the position-integration
  path qpos(t) = integratePos(qpos, qvel, t) at t = 0, which the JAX
  engine takes by two nested jax.jvp through forward kinematics. On that
  path every joint moves at its constant velocity (the exp map keeps a
  ball or free joint's angular velocity), so a body point accelerates as
  a + alpha x r + w x (v + w x r), with (alpha, a) = sum cdof_dot qvel (the
  body's spatial acceleration at qacc = 0) and (w, v) = cvel, both at the
  root's subtree com; a body's quaternion as q'' = [0, alpha] q / 2 +
  [0, w] q' / 2 with q' = [0, w] q / 2."""
  s = m.stat
  anc = table(s.ancestor_mask, d.qpos.dtype, d.qpos.device)
  cacc = anc @ (d.cdof_dot * d.qvel[..., None])  # (B, nbody, 6)

  def point_acc(body, p):
    r = p - d.subtree_com[:, int(s.body_rootid[body])]
    w, v = d.cvel[:, body, :3], d.cvel[:, body, 3:]
    return (cacc[:, body, 3:] + pmath.cross(cacc[:, body, :3], r)
            + pmath.cross(w, v + pmath.cross(w, r)))

  def quat_rates(body):  # (q, q', q'') of the body's orientation
    q, w, al = d.xquat[:, body], d.cvel[:, body, :3], cacc[:, body, :3]
    pure = lambda x: torch.cat([torch.zeros_like(x[..., :1]), x], -1)
    dq = 0.5 * pmath.mul_quat(pure(w), q)
    return q, dq, 0.5 * (pmath.mul_quat(pure(al), q)
                         + pmath.mul_quat(pure(w), dq))

  parts = []
  for e in range(s.neq):
    etype, o1, o2 = int(s.eq_type[e]), int(s.eq_obj1[e]), int(s.eq_obj2[e])
    if etype == _EQ_JOINT:
      continue
    data = m.eq_data[..., e, :]
    weld = etype == _EQ_WELD
    a1, a2 = (data[..., 3:6], data[..., 0:3]) if weld else (
        data[..., 0:3], data[..., 3:6])
    parts.append(point_acc(o1, d.xpos[:, o1] + _rot(d.xmat[:, o1], a1))
                 - point_acc(o2, d.xpos[:, o2] + _rot(d.xmat[:, o2], a2)))
    if weld:  # of tq vec(q2^-1 q1 relq)
      q1, dq1, ddq1 = quat_rates(o1)
      q2, dq2, ddq2 = (pmath.neg_quat(x) for x in quat_rates(o2))
      mq = pmath.mul_quat
      dd = mq(mq(ddq2, q1) + 2.0 * mq(dq2, dq1) + mq(q2, ddq1),
              data[..., 6:10])
      parts.append(data[..., 10, None] * dd[..., 1:4])
  return torch.cat(parts, -1)


def equality_block(m: Model, d: Data, ts, refsafe: bool):
  """The bilateral equality rows (connect, weld, joint), MuJoCo's:

  connect: residual = anchor1_w - anchor2_w, J = jacp1 - jacp2.
  weld:    position rows as connect on (x1 + R1 relpose_p) - (x2 + R2
           anchor); rotation rows r = tq vec(q2^-1 q1 relq), tq the
           torquescale, with columns 0.5 tq vec(q2^-1 [0, axis] q1 relq)
           signed by the ancestor delta.
  joint:   r = y - y0 - poly(x - x0), J = e_y - poly'(x - x0) e_x.

  aref = -b (J qvel) - k imp r - J_dot qvel, the last for connect and weld
  only (MuJoCo's). Returns (e_J (B, ne, nv), e_D, e_aref, e_active,
  e_pos), each (B, ne)."""
  s = m.stat
  dev, dtype = d.qpos.device, d.qpos.dtype
  B, nv = d.qpos.shape[0], s.nv
  disabled = bool(s.disableflags & DisableBit.EQUALITY)
  point = any(int(t) != _EQ_JOINT for t in s.eq_type[:s.neq])
  jdot = _jdot_qvel(m, d) if point else None
  iw = m.body_invweight0
  rows, row0 = [], 0

  for e in range(s.neq):
    etype, o1, o2 = int(s.eq_type[e]), int(s.eq_obj1[e]), int(s.eq_obj2[e])
    data = m.eq_data[..., e, :]
    if etype == _EQ_JOINT:
      adr1, dof1 = int(s.jnt_qposadr[o1]), int(s.jnt_dofadr[o1])
      y = d.qpos[:, adr1] - m.qpos0[..., adr1]
      if o2 >= 0:
        adr2, dof2 = int(s.jnt_qposadr[o2]), int(s.jnt_dofadr[o2])
        x = d.qpos[:, adr2] - m.qpos0[..., adr2]
      else:
        x = torch.zeros_like(y)
      k5 = torch.arange(5, dtype=dtype, device=dev)
      poly = data[..., :5]
      res = (y - (poly * x[:, None] ** k5).sum(-1))[:, None]
      dpoly = (poly[..., 1:] * k5[1:] * x[:, None] ** k5[:4]).sum(-1)
      J = torch.zeros((B, 1, nv), dtype=dtype, device=dev)
      J[:, 0, dof1] = 1.0
      diag = m.dof_invweight0[..., dof1]
      if o2 >= 0:
        J[:, 0, dof2] = J[:, 0, dof2] - dpoly
        diag = diag + m.dof_invweight0[..., dof2]
      imp_pos = res.abs()
      diag = diag[..., None].expand(B, 1)
      bias = None
    else:
      weld = etype == _EQ_WELD
      a1, a2 = (data[..., 3:6], data[..., 0:3]) if weld else (
          data[..., 0:3], data[..., 3:6])
      p1 = d.xpos[:, o1] + _rot(d.xmat[:, o1], a1)
      p2 = d.xpos[:, o2] + _rot(d.xmat[:, o2], a2)
      res = p1 - p2
      J = _body_point_jac(m, d, o1, p1) - _body_point_jac(m, d, o2, p2)
      w_t = (iw[..., o1, 0] + iw[..., o2, 0])[..., None].expand(B, 3)
      diag = w_t
      if weld:
        relq, tq = data[..., 6:10], data[..., 10]
        q2inv = pmath.neg_quat(d.xquat[:, o2])
        res_r = tq[..., None] * pmath.mul_quat(
            pmath.mul_quat(q2inv, d.xquat[:, o1]), relq)[..., 1:4]
        # rotation columns: 0.5 tq vec(q2^-1 [0, a] q1 relq), a = cdof_ang
        ancd = table(s.ancestor_mask[o1] - s.ancestor_mask[o2], dtype, dev)
        axes4 = torch.cat([torch.zeros_like(d.cdof[..., :1]),
                           d.cdof[..., :3]], -1)  # (B, nv, 4)
        q1relq = pmath.mul_quat(d.xquat[:, o1], relq)
        tmp = pmath.mul_quat(pmath.mul_quat(q2inv[:, None], axes4),
                             q1relq[:, None])  # (B, nv, 4)
        Jr = ((0.5 * tq)[..., None, None] * tmp[..., 1:4].transpose(1, 2)
              * ancd)
        J = torch.cat([J, Jr], dim=1)
        res = torch.cat([res, res_r], -1)
        w_r = (iw[..., o1, 1] + iw[..., o2, 1])[..., None].expand(B, 3)
        diag = torch.cat([w_t, w_r], -1)
      nrow = J.shape[1]
      imp_pos = torch.linalg.vector_norm(res, dim=-1, keepdim=True).expand(
          B, nrow)
      bias = jdot[:, row0:row0 + nrow]
      row0 += nrow
    b_c, k_c, imp = _kbi(m.eq_solref[..., e, None, :],
                         m.eq_solimp[..., e, None, :], imp_pos, ts, refsafe)
    vel = torch.einsum('brv,bv->br', J, d.qvel)
    r = ((1.0 - imp) / imp * diag).clamp_min(_MINVAL)
    aref = -b_c * vel - k_c * imp * res
    if bias is not None:
      aref = aref - bias
    active = (m.eq_active0[..., e] > 0) & (not disabled)
    rows.append((J, 1.0 / r, aref,
                 active[..., None].expand(B, J.shape[1]), res))
  return tuple(torch.cat([r[i] for r in rows], dim=1) for i in range(5))


def _tendon_limit_rows(m: Model, d: Data, ts, refsafe: bool):
  """The tendon-limit rows, one-sided: J = sign ten_J with sign +1 at the
  lower limit, -1 at the upper; (t_J (B, nlt, nv), t_D, t_aref, t_active,
  t_pos)."""
  lay = efc_layout(m.stat)
  tl = _ix(lay.limit_ten, d.qpos.device)
  L = d.ten_length[:, tl]
  dist_lo = L - m.tendon_range[..., tl, 0]
  dist_hi = m.tendon_range[..., tl, 1] - L
  use_lo = dist_lo <= dist_hi
  sign = torch.where(use_lo, 1.0, -1.0).to(L.dtype)
  p = torch.where(use_lo, dist_lo, dist_hi) - m.tendon_margin[..., tl]
  b, k, imp = _kbi(m.tendon_solref_lim[..., tl, :],
                   m.tendon_solimp_lim[..., tl, :], p, ts, refsafe)
  r = ((1.0 - imp) / imp * m.tendon_invweight0[..., tl]).clamp_min(_MINVAL)
  return (sign[..., None] * d.ten_J[:, tl], 1.0 / r,
          -b * sign * d.ten_velocity[:, tl] - k * imp * p, p < 0, p)


def make_efc(m: Model, d: Data) -> dict:
  """Constraint blocks, batched (B, ...):
    f_D, f_aref, f_floss, f_active           (B, nv)  friction (Huber)
    l_sign, l_D, l_aref, l_active, l_pos     (B, nl)  limits (one-sided)
    c_J (B, nc, nv), c_D, c_aref, c_active, c_pos     contacts
  with a model's equality rows (`equality_block`) as e_J (B, ne, nv), e_D,
  e_aref, e_active, e_pos, its tendon-limit rows (`_tendon_limit_rows`) as
  t_J (B, nlt, nv), t_D, t_aref, t_active, t_pos, and on an elliptic model
  the x block (`_elliptic_block`), whose c block holds the frictionless
  slots alone (one inactive row when there are none). Row order for dense
  views (efc_force): equality, friction, joint limits, tendon limits,
  contacts."""
  s = m.stat
  lay = efc_layout(s)
  dev, dtype = d.qpos.device, d.qpos.dtype
  B = d.qpos.shape[0]
  nv, nl, ncr = s.nv, lay.nl, lay.ncr
  ts = m.opt.timestep
  refsafe = not (s.disableflags & DisableBit.REFSAFE)
  zeros = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)
  false = lambda *shape: torch.zeros((B,) + shape, dtype=torch.bool,
                                     device=dev)

  # ---- dof friction rows ----
  if not (s.disableflags & DisableBit.FRICTIONLOSS):
    b, _, imp = _kbi(m.dof_solref, m.dof_solimp, torch.zeros_like(
        m.dof_frictionloss), ts, refsafe)
    r = ((1.0 - imp) / imp * m.dof_invweight0).clamp_min(_MINVAL)
    f_D = (1.0 / r).expand(B, nv)
    f_aref = -b * d.qvel
    f_floss = m.dof_frictionloss.expand(B, nv)
    f_active = (m.dof_frictionloss > 0).expand(B, nv)
  else:
    f_D, f_aref, f_floss, f_active = zeros(nv), zeros(nv), zeros(nv), \
        false(nv)

  # ---- joint limit rows ----
  if nl and not (s.disableflags & DisableBit.LIMIT):
    jids = _ix(lay.limit_jnt, dev)
    qadr = _ix(s.jnt_qposadr[lay.limit_jnt], dev)
    dadr = _ix(s.jnt_dofadr[lay.limit_jnt], dev)
    q = d.qpos[:, qadr]
    # (nl,) or per env (B, nl)
    lo, hi = m.jnt_range[..., jids, 0], m.jnt_range[..., jids, 1]
    dist_lo = q - lo
    dist_hi = hi - q
    use_lo = dist_lo <= dist_hi
    dist = torch.where(use_lo, dist_lo, dist_hi)
    l_sign = torch.where(use_lo, 1.0, -1.0).to(dtype)
    p = dist - m.jnt_margin[jids]
    b, k, imp = _kbi(m.jnt_solref[jids], m.jnt_solimp[jids], p, ts, refsafe)
    vel = l_sign * d.qvel[:, dadr]
    r = ((1.0 - imp) / imp * m.dof_invweight0[dadr]).clamp_min(_MINVAL)
    l_D = 1.0 / r
    l_aref = -b * vel - k * imp * p
    l_active = p < 0
    l_pos = p
  else:
    n1 = max(nl, 1)
    l_sign, l_D, l_aref, l_active, l_pos = (zeros(n1), zeros(n1),
                                            zeros(n1), false(n1), zeros(n1))

  # ---- tendon-limit rows (J = sign ten_J), equality rows (bilateral) ----
  rows = {}
  if lay.nlt:
    rows['t'] = (_tendon_limit_rows(m, d, ts, refsafe)
                 if not (s.disableflags & DisableBit.LIMIT)
                 else _no_rows(B, lay.nlt, nv, dtype, dev))
  if lay.ne:
    rows['e'] = equality_block(m, d, ts, refsafe)

  # ---- contact rows: the dense c block and, elliptic, the x block ----
  ell_dm = elliptic_dmax(s)
  x_block = None
  kernel = False
  if ncr and not (s.disableflags & DisableBit.CONTACT):
    if not (s.ncon_cap or s.ncon_cap1):
      contacts = _contacts_all
    else:
      kernel = contact_rows_takes(m, d)
      contacts = _contacts_kernel if kernel else contacts_compacted_plain
    (c_J, c_D, c_aref, c_active, c_pos), x_block = contacts(m, d, ts,
                                                            refsafe)
  else:
    c_J, c_D, c_aref, c_active, c_pos = _no_rows(B, max(ncr, 1), nv,
                                                 dtype, dev)
  if tracing.recording():
    tracing.count('contact_rows_kernel', torch.tensor([float(kernel)]))
  if x_block is None and ell_dm:
    x_block = _empty_elliptic(B, nv, ell_dm, dtype, dev)

  if s.disableflags & DisableBit.CONSTRAINT:
    f_active = torch.zeros_like(f_active)
    l_active = torch.zeros_like(l_active)
    c_active = torch.zeros_like(c_active)
    rows = {k: v[:3] + (torch.zeros_like(v[3]), v[4])
            for k, v in rows.items()}
    if x_block is not None:
      x_block['x_active'] = torch.zeros_like(x_block['x_active'])

  zero = torch.zeros((), dtype=dtype, device=dev)
  out = dict(
      f_D=torch.where(f_active, f_D, zero), f_aref=f_aref, f_floss=f_floss,
      f_active=f_active,
      l_sign=l_sign, l_D=torch.where(l_active, l_D, zero), l_aref=l_aref,
      l_active=l_active, l_pos=l_pos,
      c_J=c_J, c_D=torch.where(c_active, c_D, zero), c_aref=c_aref,
      c_active=c_active, c_pos=c_pos)
  for k, (J, D, aref, active, pos) in rows.items():
    out.update({f'{k}_J': J, f'{k}_D': torch.where(active, D, zero),
                f'{k}_aref': aref, f'{k}_active': active, f'{k}_pos': pos})
  if x_block is not None:
    x_block['x_D'] = torch.where(x_block['x_active'][..., None],
                                 x_block['x_D'], zero)
    out.update(x_block)
  return out


def densify_efc(stat: ModelStatic, efc: dict) -> dict:
  """Flat (B, nefc, ...) views of `make_efc`'s blocks in MuJoCo's row order
  [equality | friction | limit | contact] (tendon-limit rows after the
  joint limits), for tests and debugging against mjData.efc_* arrays."""
  lay = efc_layout(stat)
  ne, nv, nl, nlt, ncr = lay.ne, lay.nf, lay.nl, lay.nlt, lay.ncr
  c_J = efc['c_J']
  B, dtype, dev = c_J.shape[0], c_J.dtype, c_J.device
  elliptic = 'x_J' in efc
  J = torch.zeros((B, lay.nefc, nv), dtype=dtype, device=dev)
  if ne:
    J[:, :ne] = efc['e_J'][:, :ne]
  dofs = torch.arange(nv, device=dev)
  J[:, ne + dofs, dofs] = 1.0
  if nl:
    J[:, ne + nv + torch.arange(nl, device=dev),
      _ix(limit_dofadr(stat), dev)] = efc['l_sign'][:, :nl]
  if nlt:
    J[:, ne + nv + nl:ne + nv + nl + nlt] = efc['t_J'][:, :nlt]
  if ncr and not elliptic:
    J[:, ne + nv + nl + nlt:] = c_J[:, :ncr]

  def cat(e, f, l, c, t=None):
    parts = [e[:, :ne]] if ne else []
    parts += [f, l[:, :nl]]
    if nlt:
      parts.append(t[:, :nlt] if t is not None else f.new_zeros((B, nlt)))
    if ncr:
      parts.append(c.new_zeros((B, ncr)) if elliptic else c[:, :ncr])
    return torch.cat(parts, dim=1)

  get = efc.get
  ones = lambda x: torch.ones_like(x, dtype=torch.bool)
  zeros = lambda x: torch.zeros_like(x, dtype=torch.bool)
  out = dict(
      J=J,
      D=cat(get('e_D'), efc['f_D'], efc['l_D'], efc['c_D'], get('t_D')),
      aref=cat(get('e_aref'), efc['f_aref'], efc['l_aref'], efc['c_aref'],
               get('t_aref')),
      frictionloss=cat(torch.zeros_like(efc['e_D']) if ne else None,
                       efc['f_floss'],
                       torch.zeros_like(efc['l_D']),
                       torch.zeros_like(efc['c_D'])),
      active=cat(get('e_active'), efc['f_active'], efc['l_active'],
                 efc['c_active'], get('t_active')),
      oneside=cat(zeros(efc['e_active']) if ne else None,
                  zeros(efc['f_active']), ones(efc['l_active']),
                  ones(efc['c_active']),
                  ones(efc['t_active']) if nlt else None),
      pos=cat(get('e_pos'), torch.zeros_like(efc['f_D']), efc['l_pos'],
              efc['c_pos'], get('t_pos')))
  if elliptic and ncr:
    # the frictionless slots (c block) and the elliptic axes (x block) go
    # to their rows of the dense slot order; the axes beyond a slot's
    # condim map to row nefc, a spare row that is dropped
    x_rows, c1_rows = elliptic_row_maps(stat)
    nx, dm = efc['x_D'].shape[1:]
    if nx != x_rows.shape[0]:  # the empty block of a contact-free model
      x_rows = np.zeros((0, dm), np.int64)
    c1, xr = _ix(c1_rows, dev), _ix(x_rows.ravel(), dev)

    def scat(dense, cvals, xvals):
      dense = torch.cat([dense, dense[:, :1]], dim=1)
      if len(c1_rows):
        dense[:, c1] = cvals[:, :len(c1_rows)].to(dense.dtype)
      if x_rows.shape[0]:
        dense[:, xr] = xvals.reshape((B, x_rows.size) + xvals.shape[3:]
                                     ).to(dense.dtype)
      return dense[:, :-1]

    x_on = efc['x_active'][..., None].expand(B, nx, dm)
    out['J'] = scat(out['J'], c_J, efc['x_J'])
    out['D'] = scat(out['D'], efc['c_D'], efc['x_D'])
    out['aref'] = scat(out['aref'], efc['c_aref'], efc['x_aref'])
    out['active'] = scat(out['active'], efc['c_active'], x_on)
    out['pos'] = scat(out['pos'], efc['c_pos'],
                      efc['x_pos'][..., None].expand(B, nx, dm))
    out['oneside'] = scat(out['oneside'], ones(efc['c_active']), x_on)
  return out
