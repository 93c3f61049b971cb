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


def passive(m: Model, d: Data) -> Data:
  """Joint spring and damper forces."""
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


def _joint_trn(s, dev):
  """(joint-transmission actuator ids, their joints' qpos/dof addresses);
  io.put_model admits joint transmissions only."""
  jid = s.actuator_trnid[:, 0]
  return (_ix(s.jnt_qposadr[jid], dev), _ix(s.jnt_dofadr[jid], dev))


def transmission(m: Model, d: Data) -> Data:
  """Actuator lengths and velocities for joint transmissions."""
  s = m.stat
  if s.nu == 0:
    return d
  qadr, dadr = _joint_trn(s, d.qpos.device)
  gear = m.actuator_gear[:, 0]
  return d.replace(actuator_length=d.qpos[:, qadr] * gear,
                   actuator_velocity=d.qvel[:, dadr] * gear)


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
  _, dadr = _joint_trn(s, d.qpos.device)
  qfrc = torch.zeros_like(d.qvel)
  qfrc.index_add_(1, dadr, m.actuator_gear[:, 0] * force)
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
