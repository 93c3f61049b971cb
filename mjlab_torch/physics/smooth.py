"""Smooth (unconstrained) dynamics: mass matrix, bias, passive forces,
actuation and the smooth acceleration, on a batch of envs.

Counterpart of mjlab_tpu/physics/smooth.py: the CRBA and RNE recursions are
dense masked contractions over the static ancestor/subtree masks.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.ops import pd_solve as _pd_solve
from mjlab_torch.physics import math as pmath
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.tables import mask as _mask
from mjlab_torch.physics.tables import table
from mjlab_torch.physics.types import (
    BiasType,
    Data,
    DisableBit,
    GainType,
    JointType,
    Model,
)


def crb(m: Model, d: Data) -> Data:
  """Composite-rigid-body mass matrix (dense, with armature)."""
  s = m.stat
  B = d.qpos.shape[0]
  sub = _mask(s.subtree_mask, d.qpos)
  anc = _mask(s.ancestor_mask, d.qpos)
  crb_b = (sub @ d.cinr.reshape(B, s.nbody, 36)).reshape(B, s.nbody, 6, 6)
  Bd = crb_b[:, _ix(s.dof_bodyid, d.qpos.device)]  # (B, nv, 6, 6)
  t = torch.einsum('ndij,ndj->ndi', Bd, d.cdof)
  raw = t @ d.cdof.transpose(-1, -2)  # raw[i, j] = t_i . cdof_j
  mask = anc[_ix(s.dof_bodyid, d.qpos.device)]
  L = raw * (mask * torch.ones_like(mask).tril())
  qM = L + L.transpose(-1, -2) - torch.diag_embed(
      torch.diagonal(L, dim1=-2, dim2=-1))
  # armature (nv,) or per env (B, nv)
  return d.replace(qM=qM + torch.diag_embed(m.dof_armature))


def rne(m: Model, d: Data) -> Data:
  """Recursive-Newton-Euler bias force C(q, qvel)."""
  s = m.stat
  anc = _mask(s.ancestor_mask, d.qpos)
  a0 = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
  if s.disableflags & DisableBit.GRAVITY:
    a0 = torch.zeros_like(a0)
  cacc = a0 + anc @ (d.cdof_dot * d.qvel[..., None])  # (B, nbody, 6)
  cfrc = torch.einsum('nbij,nbj->nbi', d.cinr, cacc)
  cfrc = cfrc + pmath.force_cross(
      d.cvel, torch.einsum('nbij,nbj->nbi', d.cinr, d.cvel))
  qfrc_bias = torch.einsum('nik,nbk,bi->ni', d.cdof, cfrc, anc)
  return d.replace(qfrc_bias=qfrc_bias)


def tendon(m: Model, d: Data) -> Data:
  """Tendon lengths, velocities and Jacobian rows (B, ntendon, nv), as
  mj_tendon for the tendons io.put_model admits: a fixed tendon is
  constant rows (L = W_q qpos, J = W_v); a spatial tendon is a straight
  chain of sites, L = sum |p_i+1 - p_i| and J = sum u^T (Jp_i+1 - Jp_i)."""
  s = m.stat
  if not s.ntendon:
    return d
  dev = d.qpos.device
  nt = s.ntendon
  lengths = d.qpos @ _mask(s.ten_coef_q[:nt], d.qpos).T  # (B, nt)
  J = _mask(s.ten_coef_v[:nt], d.qpos)  # (nt, nv)
  anc = _mask(s.ancestor_mask, d.qpos)
  cdof_ang = d.cdof[..., :3]
  cdof_lin = d.cdof[..., 3:]

  def point_jac(body, p):  # (B, nv, 3) of a world point p (B, 3) on body
    croot = d.subtree_com[:, int(s.body_rootid[body])]
    col = cdof_lin + pmath.cross(cdof_ang, (p - croot)[:, None, :])
    return col * anc[body][:, None]

  cols_L, cols_J = [], []
  for t, chain in enumerate(s.ten_site_chains):
    if not chain:
      cols_L.append(lengths[:, t])
      cols_J.append(J[t].expand(d.qpos.shape[0], s.nv))
      continue
    L = torch.zeros_like(lengths[:, t])
    row = torch.zeros_like(d.qvel)
    for a, b in zip(chain[:-1], chain[1:]):
      pa, pb = d.site_xpos[:, a], d.site_xpos[:, b]
      seg = pb - pa
      ln = torch.sqrt((seg * seg).sum(-1).clamp_min(1e-24))
      u = seg / ln[:, None]
      L = L + ln
      jab = (point_jac(int(s.site_bodyid[b]), pb)
             - point_jac(int(s.site_bodyid[a]), pa))
      row = row + torch.einsum('bvx,bx->bv', jab, u)
    cols_L.append(L)
    cols_J.append(row)
  ten_J = torch.stack(cols_J, dim=1)
  return d.replace(ten_length=torch.stack(cols_L, dim=1), ten_J=ten_J,
                   ten_velocity=torch.einsum('btv,bv->bt', ten_J, d.qvel))


def passive(m: Model, d: Data) -> Data:
  """Joint and tendon spring and damper forces (a tendon's spring acts
  outside its deadband [lengthspring0, lengthspring1] only)."""
  s = m.stat
  dev = d.qpos.device
  if s.disableflags & DisableBit.PASSIVE:
    z = torch.zeros_like(d.qvel)
    return d.replace(qfrc_passive=z, qfrc_spring=z, qfrc_damper=z)

  qfrc_spring = torch.zeros_like(d.qvel)
  for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
             JointType.HINGE):
    jsel_np = np.nonzero(s.jnt_type == int(jt))[0]
    if len(jsel_np) == 0:
      continue
    stiff = m.jnt_stiffness[..., _ix(jsel_np, dev)]  # (k,) or (B, k)
    qadr = s.jnt_qposadr[jsel_np]
    dadr = s.jnt_dofadr[jsel_np]
    if jt in (JointType.SLIDE, JointType.HINGE):
      tq = _ix(qadr, dev)
      qfrc_spring[:, _ix(dadr, dev)] = -stiff * (
          d.qpos[:, tq] - m.qpos_spring[tq])
    else:
      nq = 4 if jt == JointType.BALL else 7
      tq = _ix(qadr[:, None] + np.arange(nq)[None, :], dev)
      q, qs = d.qpos[:, tq], m.qpos_spring[tq]
      if jt == JointType.BALL:
        parts = [_quat_sub(q, qs)]
      else:
        parts = [q[..., :3] - qs[..., :3],
                 _quat_sub(q[..., 3:7], qs[..., 3:7])]
      off = 0
      for part in parts:
        for i in range(3):
          qfrc_spring[:, _ix(dadr + off + i, dev)] = -stiff * part[..., i]
        off += 3

  qfrc_damper = -m.dof_damping * d.qvel
  if s.ntendon:
    L, ls = d.ten_length, m.tendon_lengthspring
    zero = L.new_zeros(())
    disp = torch.where(L < ls[..., 0], ls[..., 0] - L,
                       torch.where(L > ls[..., 1], ls[..., 1] - L, zero))
    f_spring = m.tendon_stiffness * disp
    f_damper = -m.tendon_damping * d.ten_velocity
    qfrc_spring = qfrc_spring + torch.einsum('bt,btv->bv', f_spring, d.ten_J)
    qfrc_damper = qfrc_damper + torch.einsum('bt,btv->bv', f_damper, d.ten_J)
  return d.replace(qfrc_passive=qfrc_spring + qfrc_damper,
                   qfrc_spring=qfrc_spring, qfrc_damper=qfrc_damper)


def _quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Rotational velocity taking qb to qa in unit time (mju_subQuat)."""
  q = pmath.mul_quat(pmath.neg_quat(qb), qa)
  q = torch.where(q[..., :1] < 0, -q, q)
  sin_half = torch.linalg.vector_norm(q[..., 1:], dim=-1)
  angle = 2.0 * torch.atan2(sin_half, q[..., 0])
  axis = q[..., 1:] / sin_half.clamp_min(1e-12)[..., None]
  return torch.where((sin_half > 1e-12)[..., None], axis * angle[..., None],
                     2.0 * q[..., 1:])


_DYN_INTEGRATOR = 1
_DYN_FILTEREXACT = 3


def act_groups(s, dev):
  """(ids of the actuators with an activation state, the same as an index
  tensor, and their act slots as an index tensor)."""
  actadr = np.asarray(s.actuator_actadr)
  asel = np.nonzero(actadr >= 0)[0]
  return asel, _ix(asel, dev), _ix(actadr[asel], dev)


def act_input(m: Model, d: Data, ctrl: torch.Tensor):
  """(actuator input with each stateful actuator's act in place of its
  ctrl, act_dot): act_dot = ctrl (integrator) or (ctrl - act) / tau
  (filter, filterexact)."""
  s = m.stat
  asel, ta, ti = act_groups(s, ctrl.device)
  act_u = d.act[:, ti]
  inp = ctrl.clone()
  inp[:, ta] = act_u
  integ = table(s.actuator_dyntype[asel] == _DYN_INTEGRATOR, torch.bool,
                ctrl.device)
  tau = m.actuator_dynprm[ta, 0].clamp_min(1e-15)
  act_dot = torch.zeros_like(d.act_dot)
  act_dot[:, ti] = torch.where(integ, ctrl[:, ta],
                               (ctrl[:, ta] - act_u) / tau)
  return inp, act_dot


_TRN_JOINT = 0  # mjtTrn


def trn_tables(s, dev):
  """Per actuator, the tables of its transmission (io.put_model admits
  joint and tendon ones): (qpos address, dof address, tendon id, and a
  (nu,) bool tensor marking the tendon actuators, or None when every
  actuator drives a joint). An actuator's entries of the other kind are
  0, masked by the caller."""
  ids = np.asarray(s.actuator_trnid)[:, 0]
  joint = np.asarray(s.actuator_trntype) == _TRN_JOINT
  jid = np.where(joint, ids, 0)
  ten = None if joint.all() else table(~joint, torch.bool, dev)
  return (_ix(s.jnt_qposadr[jid], dev), _ix(s.jnt_dofadr[jid], dev),
          _ix(np.where(joint, 0, ids), dev), ten)


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths and velocities for joint and tendon transmissions."""
  s = m.stat
  if s.nu == 0:
    return d
  qadr, dadr, tid, ten = trn_tables(s, d.qpos.device)
  gear = m.actuator_gear[:, 0]
  length, velocity = d.qpos[:, qadr], d.qvel[:, dadr]
  if ten is not None:
    length = torch.where(ten, d.ten_length[:, tid], length)
    velocity = torch.where(ten, d.ten_velocity[:, tid], velocity)
  return d.replace(actuator_length=length * gear,
                   actuator_velocity=velocity * gear)


def clamp_ctrl(m: Model, ctrl: torch.Tensor) -> torch.Tensor:
  s = m.stat
  if s.disableflags & DisableBit.CLAMPCTRL:
    return ctrl
  limited = table(s.actuator_ctrllimited, torch.bool, ctrl.device)
  clamped = torch.minimum(torch.maximum(ctrl, m.actuator_ctrlrange[:, 0]),
                          m.actuator_ctrlrange[:, 1])
  return torch.where(limited, clamped, ctrl)


def gain_bias(m: Model, d: Data):
  """Per-actuator (gain, bias) for FIXED/AFFINE gain and NONE/AFFINE bias."""
  s = m.stat
  dev = d.qpos.device
  fixed = table(s.actuator_gaintype == int(GainType.FIXED), torch.bool, dev)
  affine = table(s.actuator_biastype == int(BiasType.AFFINE), torch.bool,
                 dev)
  gp, bp = m.actuator_gainprm, m.actuator_biasprm
  gain = torch.where(fixed, gp[:, 0], gp[:, 0] + gp[:, 1] * d.actuator_length
                     + gp[:, 2] * d.actuator_velocity)
  bias = torch.where(affine, bp[:, 0] + bp[:, 1] * d.actuator_length
                     + bp[:, 2] * d.actuator_velocity,
                     torch.zeros_like(d.actuator_length))
  return gain, bias


def actuation(m: Model, d: Data) -> Data:
  """Actuator forces and their joint-space map (motor, position and
  velocity servos: gain FIXED/AFFINE, bias NONE/AFFINE)."""
  s = m.stat
  if s.nu == 0 or (s.disableflags & DisableBit.ACTUATION):
    return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))
  gain, bias = gain_bias(m, d)
  inp = clamp_ctrl(m, d.ctrl)
  if s.na:
    inp, act_dot = act_input(m, d, inp)
    d = d.replace(act_dot=act_dot)
  force = gain * inp + bias
  limited = table(s.actuator_forcelimited, torch.bool, force.device)
  fr = m.actuator_forcerange
  force = torch.where(
      limited, torch.minimum(torch.maximum(force, fr[:, 0]), fr[:, 1]),
      force)
  _, dadr, tid, ten = trn_tables(s, d.qpos.device)
  frc = m.actuator_gear[:, 0] * force
  qfrc = torch.zeros_like(d.qvel)
  if ten is None:
    qfrc.index_add_(1, dadr, frc)
  else:  # a tendon actuator's force maps through its tendon's J row
    zero = frc.new_zeros(())
    qfrc.index_add_(1, dadr, torch.where(ten, zero, frc))
    qfrc = qfrc + torch.einsum('bu,buv->bv', torch.where(ten, frc, zero),
                               d.ten_J[:, tid])
  return d.replace(actuator_force=force, qfrc_actuator=qfrc)


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
  """Map xfrc_applied ([force, torque] at body CoM, world) to joint space."""
  s = m.stat
  anc = _mask(s.ancestor_mask, d.qpos)
  frc = d.xfrc_applied[..., :3]
  trq = d.xfrc_applied[..., 3:]
  r = d.xipos - d.subtree_com[:, _ix(s.body_rootid, d.qpos.device)]
  cfrc = torch.cat([trq + pmath.cross(r, frc), frc], dim=-1)
  return torch.einsum('nik,nbk,bi->ni', d.cdof, cfrc, anc)


def fwd_smooth(m: Model, d: Data) -> Data:
  """qfrc_smooth and qacc_smooth (unconstrained acceleration)."""
  qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                 + d.qfrc_applied + xfrc_accumulate(m, d))
  qacc_smooth = _pd_solve.solve_pd(d.qM, qfrc_smooth)
  return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)
