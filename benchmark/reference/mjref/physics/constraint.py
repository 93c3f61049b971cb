"""Constraint row assembly (dof friction, joint limits, contacts),
batched.

Counterpart of mjlab_tpu/physics/constraint.py, for the configured
scenes: pyramidal cone, compacted contacts, no equality constraints and no
tendons (`make_efc` raises on any other model). The row layout is static
and in MuJoCo's order: a friction-loss row for every dof (J = I, masked by
frictionloss > 0), a limit row for every limited hinge/slide joint
(one-hot J), and the contact block, the rows of the deepest candidates
chosen per env from two static slot pools (frictional and frictionless).
A slot of condim d has 2 (d - 1) rows (Jn +- mu_i T_i), one when d == 1.
Inactive rows carry zero D, so the solver's shapes never change.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mjref.physics import math as pmath
from mjref.physics.tables import ix as _ix
from mjref.physics.tables import table
from mjref.physics.types import (
    ConeType,
    Data,
    DisableBit,
    JointType,
    Model,
    ModelStatic,
)

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
  Nonzero: make_efc raises (the elliptic block is not copied)."""
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


def _contacts_compacted(m: Model, d: Data, ts, refsafe: bool):
  """Contact rows of the deepest candidate slots of each pool: uniform
  pyramidal blocks of 2*(maxdim-1) rows for frictional slots, one normal
  row for frictionless ones. Returns the c block's five tensors."""
  s = m.stat
  B = d.qpos.shape[0]
  K3, K1 = s.ncon_cap, s.ncon_cap1
  A = max(int(s.con_dim.max()) - 1, 1)
  slots3, slots1 = compaction_slot_pools(s)
  impratio = m.opt.impratio
  blocks = []

  if K3:
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

  return tuple(torch.cat([blk[i] for blk in blocks], dim=1)
               for i in range(5))


def _no_rows(B: int, n: int, nv: int, dtype, dev):
  """(J, D, aref, active, pos) of n contact rows with nothing active."""
  z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)
  return (z(n, nv), z(n), z(n),
          torch.zeros((B, n), dtype=torch.bool, device=dev), z(n))


def make_efc(m: Model, d: Data) -> dict:
  """Constraint blocks, batched (B, ...):
    f_D, f_aref, f_floss, f_active           (B, nv)  friction (Huber)
    l_sign, l_D, l_aref, l_active, l_pos     (B, nl)  limits (one-sided)
    c_J (B, nc, nv), c_D, c_aref, c_active, c_pos     contacts
  of a pyramidal model with compacted contacts and no equality or
  tendon-limit rows (what the configured scenes hold; any other raises).
  Row order for dense views (efc_force): friction, joint limits,
  contacts."""
  s = m.stat
  lay = efc_layout(s)
  if lay.ne or lay.nlt or elliptic_dmax(s) or not (s.ncon_cap
                                                    or s.ncon_cap1):
    raise NotImplementedError(
        'mjref assembles the rows of pyramidal models with compacted '
        'contacts and no equality or tendon-limit rows')
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

  # ---- contact rows ----
  if ncr and not (s.disableflags & DisableBit.CONTACT):
    c_J, c_D, c_aref, c_active, c_pos = _contacts_compacted(m, d, ts,
                                                            refsafe)
  else:
    c_J, c_D, c_aref, c_active, c_pos = _no_rows(B, max(ncr, 1), nv,
                                                 dtype, dev)

  if s.disableflags & DisableBit.CONSTRAINT:
    f_active = torch.zeros_like(f_active)
    l_active = torch.zeros_like(l_active)
    c_active = torch.zeros_like(c_active)

  zero = torch.zeros((), dtype=dtype, device=dev)
  out = dict(
      f_D=torch.where(f_active, f_D, zero), f_aref=f_aref, f_floss=f_floss,
      f_active=f_active,
      l_sign=l_sign, l_D=torch.where(l_active, l_D, zero), l_aref=l_aref,
      l_active=l_active, l_pos=l_pos,
      c_J=c_J, c_D=torch.where(c_active, c_D, zero), c_aref=c_aref,
      c_active=c_active, c_pos=c_pos)
  return out
