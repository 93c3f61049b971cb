"""Forward kinematics and COM-frame quantities on a batch of envs.

Counterpart of mjlab_tpu/physics/kinematics.py. The tree is walked level by
level (all bodies at one depth at once, with static gather indices), and
bodies within a level are split by joint type on the host, so no per-env
branching is needed. Subtree sums and velocities are dense masked matmuls
over the static ancestor/subtree masks.

A model field may carry a leading env axis (per-env domain randomization,
sim.sim.PER_ENV_FIELDS): every read indexes the entity axis from the end
(`[..., ids, :]`), so a field's rows broadcast over the batch whether it
is shared or per env.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.physics import math as pmath
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.tables import mask as _mask
from mjlab_torch.physics.types import Data, JointType, Model


def kinematics(m: Model, d: Data) -> Data:
  """mj_kinematics analog: body/geom/site frames from qpos."""
  s = m.stat
  dev, dtype = d.qpos.device, d.qpos.dtype
  B = d.qpos.shape[0]

  xpos = torch.zeros((B, s.nbody, 3), dtype=dtype, device=dev)
  xquat = torch.zeros((B, s.nbody, 4), dtype=dtype, device=dev)
  xquat[..., 0] = 1.0
  xanchor = torch.zeros((B, max(s.njnt, 1), 3), dtype=dtype, device=dev)
  xaxis = torch.zeros_like(xanchor)

  for ids in s.body_levels:
    tids = _ix(ids, dev)
    pid = _ix(s.body_parentid[ids], dev)
    p_pos = xpos[:, pid]
    p_quat = xquat[:, pid]
    pos = p_pos + pmath.rot_vec_quat(m.body_pos[..., tids, :], p_quat)
    quat = pmath.mul_quat(p_quat, m.body_quat[..., tids, :])

    if s.nmocap:  # mocap bodies take the pose the caller set
      msel = np.nonzero(s.body_mocapid[ids] >= 0)[0]
      if len(msel):
        mid = _ix(s.body_mocapid[ids][msel], dev)
        pos[:, _ix(msel, dev)] = d.mocap_pos[:, mid]
        quat[:, _ix(msel, dev)] = pmath.normalize_quat(d.mocap_quat[:, mid])

    max_jnt = int(s.body_jntnum[ids].max()) if len(ids) else 0
    for k in range(max_jnt):
      has = s.body_jntnum[ids] > k
      jid = np.where(has, s.body_jntadr[ids] + k, 0)
      for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
                 JointType.HINGE):
        sel_np = np.nonzero(has & (s.jnt_type[jid] == int(jt)))[0]
        if len(sel_np) == 0:
          continue
        sel = _ix(sel_np, dev)
        jsel_np = jid[sel_np]
        jsel = _ix(jsel_np, dev)
        qadr = s.jnt_qposadr[jsel_np]

        if jt == JointType.FREE:
          q7 = d.qpos[:, _ix(qadr[:, None] + np.arange(7)[None, :], dev)]
          new_pos = q7[..., :3]
          pos[:, sel] = new_pos
          quat[:, sel] = pmath.normalize_quat(q7[..., 3:7])
          xanchor[:, jsel] = new_pos
          xaxis[:, jsel] = _mask(pmath._EZ, d.qpos)
          continue

        jpos = m.jnt_pos[..., jsel, :]
        jaxis = m.jnt_axis[..., jsel, :]
        anchor = pos[:, sel] + pmath.rot_vec_quat(jpos, quat[:, sel])
        axis_w = pmath.rot_vec_quat(jaxis, quat[:, sel])
        xanchor[:, jsel] = anchor
        xaxis[:, jsel] = axis_w

        if jt == JointType.SLIDE:
          tq = _ix(qadr, dev)
          delta = d.qpos[:, tq] - m.qpos0[..., tq]
          pos[:, sel] = pos[:, sel] + axis_w * delta[..., None]
        else:
          if jt == JointType.HINGE:
            tq = _ix(qadr, dev)
            angle = d.qpos[:, tq] - m.qpos0[..., tq]
            qloc = pmath.axis_angle_to_quat(jaxis, angle)
          else:  # BALL
            qloc = pmath.normalize_quat(
                d.qpos[:, _ix(qadr[:, None] + np.arange(4)[None, :], dev)])
          new_quat = pmath.mul_quat(quat[:, sel], qloc)
          quat[:, sel] = new_quat
          pos[:, sel] = anchor - pmath.rot_vec_quat(jpos, new_quat)

    xpos[:, tids] = pos
    xquat[:, tids] = pmath.normalize_quat(quat)

  xmat = pmath.quat_to_mat(xquat)
  xipos = xpos + pmath.rot_vec_quat(m.body_ipos, xquat)
  ximat = pmath.quat_to_mat(pmath.mul_quat(xquat, m.body_iquat))

  gb = _ix(s.geom_bodyid, dev)
  geom_xpos = xpos[:, gb] + pmath.rot_vec_quat(m.geom_pos, xquat[:, gb])
  geom_xmat = pmath.quat_to_mat(pmath.mul_quat(xquat[:, gb], m.geom_quat))

  if s.nsite:
    sb = _ix(s.site_bodyid, dev)
    site_xpos = xpos[:, sb] + pmath.rot_vec_quat(m.site_pos, xquat[:, sb])
    site_xmat = pmath.quat_to_mat(pmath.mul_quat(xquat[:, sb], m.site_quat))
  else:
    site_xpos, site_xmat = d.site_xpos, d.site_xmat

  return d.replace(
      xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
      xanchor=xanchor, xaxis=xaxis, geom_xpos=geom_xpos,
      geom_xmat=geom_xmat, site_xpos=site_xpos, site_xmat=site_xmat)


def com_pos(m: Model, d: Data) -> Data:
  """mj_comPos analog: subtree_com, spatial inertias (cinr), cdof."""
  s = m.stat
  dev, dtype = d.qpos.device, d.qpos.dtype
  sub = _mask(s.subtree_mask, d.qpos)

  mass = m.body_mass  # (nbody,) or (B, nbody)
  weighted = mass[..., None] * d.xipos  # (B, nbody, 3)
  subtree_mass = (sub @ mass[..., None])[..., 0]
  subtree_com = (sub @ weighted) / subtree_mass.clamp_min(1e-12)[..., None]

  root = _ix(s.body_rootid, dev)
  croot = subtree_com[:, root]
  inertia = m.body_inertia
  inert_world = torch.einsum(
      'nbij,bj,nbkj->nbik' if inertia.dim() == 2 else 'nbij,nbj,nbkj->nbik',
      d.ximat, inertia, d.ximat)
  cinr = pmath.spatial_inertia(mass, inert_world, d.xipos - croot)

  B = d.qpos.shape[0]
  cdof = torch.zeros((B, s.nv, 6), dtype=dtype, device=dev)
  for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
             JointType.HINGE):
    jsel_np = np.nonzero(s.jnt_type == int(jt))[0]
    if len(jsel_np) == 0:
      continue
    jsel = _ix(jsel_np, dev)
    dadr = s.jnt_dofadr[jsel_np]
    b = _ix(s.jnt_bodyid[jsel_np], dev)
    if jt == JointType.SLIDE:
      ax = d.xaxis[:, jsel]
      cdof[:, _ix(dadr, dev)] = torch.cat([torch.zeros_like(ax), ax], -1)
    elif jt == JointType.HINGE:
      ax = d.xaxis[:, jsel]
      off = croot[:, b] - d.xanchor[:, jsel]
      cdof[:, _ix(dadr, dev)] = torch.cat([ax, pmath.cross(ax, off)], -1)
    else:
      R = d.xmat[:, b]  # columns are body axes in world
      off = croot[:, b] - d.xanchor[:, jsel]
      rot0 = 0
      if jt == JointType.FREE:  # 3 world translations, 3 body rotations
        for i in range(3):
          cdof[:, _ix(dadr + i, dev), 3 + i] = 1.0
        rot0 = 3
      for i in range(3):
        ax = R[..., :, i]
        cdof[:, _ix(dadr + rot0 + i, dev)] = torch.cat(
            [ax, pmath.cross(ax, off)], -1)

  return d.replace(subtree_com=subtree_com, cinr=cinr, cdof=cdof)


def com_vel(m: Model, d: Data) -> Data:
  """mj_comVel analog: body spatial velocities and cdof time-derivatives."""
  s = m.stat
  anc = _mask(s.ancestor_mask, d.qpos)
  prefix = _mask(s.dof_prefix_mask, d.qpos)
  dof_vel = d.cdof * d.qvel[..., None]  # (B, nv, 6)
  cvel = anc @ dof_vel
  prefix_vel = prefix @ dof_vel
  cdof_dot = pmath.motion_cross(prefix_vel, d.cdof)
  return d.replace(cvel=cvel, cdof_dot=cdof_dot)
