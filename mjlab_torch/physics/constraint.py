"""Constraint row assembly (dof friction, joint limits, contacts), batched.

Counterpart of mjlab_tpu/physics/constraint.py without equality rows. The
row layout is static: every dof has a friction-loss row (J = I, masked by
frictionloss > 0), every limited hinge/slide joint a limit row (one-hot
J), and the contact block holds either the rows of every candidate contact
slot or, with compaction (large pair tables), the rows of the deepest
candidates chosen per env from two static slot pools (frictional and
frictionless). Inactive rows carry zero D, so the solver's shapes never
change.

Pyramidal cone: a slot of condim d has 2 (d - 1) rows (Jn +- mu_i T_i),
one when d == 1, all in the dense `c_*` block. Elliptic cone: a
frictional slot has d rows (normal, then its friction axes) in the
structured `x_*` block, one entry per slot, which the solver's cone cost
couples; frictionless slots keep one normal row in the `c_*` block.

Equality rows raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

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

_MINIMP = 0.0001
_MAXIMP = 0.9999
_MINVAL = 1e-15


@dataclasses.dataclass(frozen=True)
class EfcLayout:
  """Row order matches MuJoCo's efc arrays: [friction | limits | contacts]."""
  nefc: int
  nf: int
  limit_jnt: np.ndarray  # joint ids with limit rows
  con_base: np.ndarray  # first row of each contact slot (or pool slot)

  @property
  def nl(self) -> int:
    return len(self.limit_jnt)

  @property
  def ncr(self) -> int:
    """Total dense contact rows."""
    return self.nefc - self.nf - self.nl


def _check_supported(stat: ModelStatic) -> None:
  if stat.neq:
    raise NotImplementedError('equality constraint rows are not '
                              'implemented in mjlab_torch yet')


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
  _check_supported(stat)
  nf = stat.nv
  limit_jnt = np.nonzero(
      stat.jnt_limited &
      np.isin(stat.jnt_type, (int(JointType.HINGE), int(JointType.SLIDE))))[0]
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
  base0 = nf + len(limit_jnt)
  con_base = (base0 + np.cumsum(con_rows) - con_rows).astype(np.int32)
  return EfcLayout(nefc=base0 + int(con_rows.sum()), nf=nf,
                   limit_jnt=limit_jnt, con_base=con_base)


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
  sel = torch.sort(-p_pool, dim=-1, descending=True, stable=True)[1][:, :K]
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


def _contacts_compacted(m: Model, d: Data, ts, refsafe: bool):
  """Contact rows of the deepest candidate slots of each pool: uniform
  pyramidal blocks of 2*(maxdim-1) rows for frictional slots (elliptic:
  the x block of those slots), one normal row for frictionless ones.
  Returns the c block's five tensors and the x block or None."""
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
  row0 = lay.nf + lay.nl
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


def make_efc(m: Model, d: Data) -> dict:
  """Constraint blocks, batched (B, ...):
    f_D, f_aref, f_floss, f_active           (B, nv)  friction (Huber)
    l_sign, l_D, l_aref, l_active, l_pos     (B, nl)  limits (one-sided)
    c_J (B, nc, nv), c_D, c_aref, c_active, c_pos     contacts
  and on an elliptic model the x block (`_elliptic_block`), whose c block
  holds the frictionless slots alone (one inactive row when there are
  none). Row order for dense views (efc_force): friction, limits,
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

  # ---- contact rows: the dense c block and, elliptic, the x block ----
  ell_dm = elliptic_dmax(s)
  x_block = None
  if ncr and not (s.disableflags & DisableBit.CONTACT):
    contacts = (_contacts_compacted if (s.ncon_cap or s.ncon_cap1)
                else _contacts_all)
    (c_J, c_D, c_aref, c_active, c_pos), x_block = contacts(m, d, ts,
                                                            refsafe)
  else:
    c_J, c_D, c_aref, c_active, c_pos = _no_rows(B, max(ncr, 1), nv,
                                                 dtype, dev)
  if x_block is None and ell_dm:
    x_block = _empty_elliptic(B, nv, ell_dm, dtype, dev)

  if s.disableflags & DisableBit.CONSTRAINT:
    f_active = torch.zeros_like(f_active)
    l_active = torch.zeros_like(l_active)
    c_active = torch.zeros_like(c_active)
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
  if x_block is not None:
    x_block['x_D'] = torch.where(x_block['x_active'][..., None],
                                 x_block['x_D'], zero)
    out.update(x_block)
  return out
