"""Entity: one physical object (robot, prop) of the scene.

Counterpart of mjlab_tpu/entity/entity.py.

  * `Entity` is the build-time object (on a host with mujoco): the MjSpec of
    its cfg's `spec_fn`, the cfg's actuators and spec editors applied to
    it, and the `init_state` keyframe added (scene/scene.py attaches it to
    the scene's spec under the prefix `<name>/`).
  * `EntityIndexing` is the static index metadata (numpy), read from the
    compiled scene's name table (a `mujoco.MjModel`, or its `ModelArrays`
    snapshot on a host that may lack the mujoco package): an entity is
    everything named under its prefix (`robot/...`), in compiled order,
    with the prefix cut off.
  * `EntityView` is the runtime facade over the batched `physics.Data`:
    reads are gathers, writes return a new Data and never write into the
    tensors of the Data they were given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from mjlab_torch.entity.spec_config import (
    ActuatorCfg,
    ActuatorSetCfg,
    SpecCfg,
)
from mjlab_torch.physics.io import names_of
from mjlab_torch.physics.tables import ix, table
from mjlab_torch.physics.types import Data, JointType, StaticBase
from mjlab_torch.utils import math as tmath
from mjlab_torch.utils.string import resolve_matching_names_values


# constant vectors come from the table cache: a tensor made from a Python
# list on every call would copy to the device, and wait for it, every time
_DOWN = np.array([0.0, 0.0, -1.0])
_FORWARD = np.array([1.0, 0.0, 0.0])


@dataclasses.dataclass
class EntityInitStateCfg:
  pos: tuple = (0.0, 0.0, 0.0)
  rot: tuple = (1.0, 0.0, 0.0, 0.0)
  lin_vel: tuple = (0.0, 0.0, 0.0)
  ang_vel: tuple = (0.0, 0.0, 0.0)
  joint_pos: dict = dataclasses.field(default_factory=lambda: {'.*': 0.0})
  joint_vel: dict = dataclasses.field(default_factory=lambda: {'.*': 0.0})


@dataclasses.dataclass
class EntityCfg:
  """`spec_fn` builds the entity's MjSpec (None: the entity comes only from
  a compiled scene, as a snapshot holds it); `actuators` and then each of
  `spec_editors` edit that spec; `init_state` is also its keyframe."""
  spec_fn: 'Callable | None' = None
  init_state: EntityInitStateCfg = dataclasses.field(
      default_factory=EntityInitStateCfg)
  actuators: 'tuple[ActuatorCfg, ...]' = ()
  spec_editors: 'tuple[SpecCfg, ...]' = ()
  soft_joint_pos_limit_factor: float = 1.0


class Entity:
  """Build-time entity: the MjSpec of `cfg.spec_fn()` with the actuators
  (ActuatorSetCfg) and then each spec editor applied, and an 'init_state'
  keyframe: qpos = [pos, rot, joint_pos], and ctrl = the joint targets when
  every scalar joint is actuated."""

  def __init__(self, cfg: EntityCfg):
    import mujoco
    self.cfg = cfg
    if cfg.spec_fn is None:
      raise ValueError('EntityCfg.spec_fn is required to build an entity')
    self.spec = cfg.spec_fn()
    if cfg.actuators:
      ActuatorSetCfg(cfgs=tuple(cfg.actuators)).edit_spec(self.spec)
    for editor in cfg.spec_editors:
      editor.edit_spec(self.spec)
    free = mujoco.mjtJoint.mjJNT_FREE
    joints = list(self.spec.joints)
    self._free_joints = [j.name for j in joints if j.type == free]
    if len(self._free_joints) > 1:
      raise ValueError('entity can have at most one free joint')
    self._joints = [j for j in joints if j.type != free]
    self.joint_names = [j.name for j in self._joints]
    self.actuator_names = [a.name for a in self.spec.actuators]
    self._add_initial_state_keyframe()

  def _add_initial_state_keyframe(self) -> None:
    import mujoco
    init = self.cfg.init_state
    qpos_parts = []
    if self._free_joints:
      qpos_parts.extend([list(init.pos), list(init.rot)])
    joint_pos = None
    if self.joint_names:
      jp = np.zeros(len(self.joint_names))
      ids, _, vals = resolve_matching_names_values(
          init.joint_pos, self.joint_names)
      jp[ids] = vals
      joint_pos = jp
      # a hinge or slide joint holds one qpos, a ball joint four
      for i, j in enumerate(self._joints):
        qpos_parts.append([1.0, 0.0, 0.0, 0.0]
                          if j.type == mujoco.mjtJoint.mjJNT_BALL
                          else [jp[i]])
    key_qpos = np.hstack(qpos_parts) if qpos_parts else np.array([])
    key = self.spec.add_key(name='init_state', qpos=key_qpos)
    if joint_pos is not None and len(self.actuator_names) == len(joint_pos):
      key.ctrl = joint_pos


@dataclasses.dataclass(frozen=True, eq=False)
class EntityIndexing(StaticBase):
  """Static global indices for one entity inside the compiled scene."""
  body_ids: np.ndarray
  root_body_id: int
  geom_ids: np.ndarray
  site_ids: np.ndarray
  jnt_ids: np.ndarray  # non-free joints, entity order
  q_adr: np.ndarray  # qpos addresses of non-free (scalar) joints
  v_adr: np.ndarray
  free_jnt_id: int  # -1 if fixed base
  free_q_adr: np.ndarray  # (7,) or empty
  free_v_adr: np.ndarray  # (6,) or empty
  ctrl_ids: np.ndarray  # actuator ids, entity order
  body_names: tuple
  joint_names: tuple
  geom_names: tuple
  site_names: tuple
  actuator_names: tuple
  sensor_map: tuple  # ((name, adr, dim), ...)


def _under_prefix(mj_model, kind: str, count: int, prefix: str):
  """(ids, names without the prefix) of the named objects of one kind under
  `prefix`, in compiled order. An object the spec left unnamed compiles to
  the bare prefix and is not the entity's to address."""
  ids, names = [], []
  for i, name in enumerate(names_of(mj_model, kind, count)):
    if name.startswith(prefix) and len(name) > len(prefix):
      ids.append(i)
      names.append(name[len(prefix):])
  return np.asarray(ids, np.int32), tuple(names)


def compute_indexing(mj_model, prefix: str) -> EntityIndexing:
  """Resolve the global ids of the entity under `prefix` in the compiled
  scene `mj_model` (a mujoco.MjModel or a ModelArrays)."""
  m = mj_model
  body_ids, body_names = _under_prefix(m, 'body', m.nbody, prefix)
  geom_ids, geom_names = _under_prefix(m, 'geom', m.ngeom, prefix)
  site_ids, site_names = _under_prefix(m, 'site', m.nsite, prefix)
  all_jnt, all_jnt_names = _under_prefix(m, 'jnt', m.njnt, prefix)
  ctrl_ids, actuator_names = _under_prefix(m, 'actuator', m.nu, prefix)
  sensor_ids, sensor_names = _under_prefix(m, 'sensor', m.nsensor, prefix)

  jnt_type = np.asarray(m.jnt_type)
  is_free = jnt_type[all_jnt] == int(JointType.FREE)
  if is_free.sum() > 1:
    raise ValueError('entity can have at most one free joint')
  jnt_ids = all_jnt[~is_free]
  joint_names = tuple(n for n, f in zip(all_jnt_names, is_free) if not f)
  q_adr = np.asarray(m.jnt_qposadr)[jnt_ids]
  v_adr = np.asarray(m.jnt_dofadr)[jnt_ids]
  if is_free.any():
    fj = int(all_jnt[is_free][0])
    fq = int(m.jnt_qposadr[fj]) + np.arange(7)
    fv = int(m.jnt_dofadr[fj]) + np.arange(6)
    root_body = int(m.jnt_bodyid[fj])
  else:
    fj, fq, fv = -1, np.zeros(0, np.int64), np.zeros(0, np.int64)
    root_body = int(body_ids[0]) if len(body_ids) else 0
  sensor_map = tuple(
      (n, int(m.sensor_adr[i]), int(m.sensor_dim[i]))
      for i, n in zip(sensor_ids, sensor_names))
  return EntityIndexing(
      body_ids=body_ids, root_body_id=root_body, geom_ids=geom_ids,
      site_ids=site_ids, jnt_ids=jnt_ids,
      q_adr=q_adr.astype(np.int32), v_adr=v_adr.astype(np.int32),
      free_jnt_id=fj, free_q_adr=fq.astype(np.int32),
      free_v_adr=fv.astype(np.int32), ctrl_ids=ctrl_ids,
      body_names=body_names, joint_names=joint_names, geom_names=geom_names,
      site_names=site_names, actuator_names=actuator_names,
      sensor_map=sensor_map)


class EntityView:
  """Runtime facade over batched Data for one entity.

  Every read takes the batched Data and returns (num_envs, ...) tensors;
  every write returns a new Data. `device` and `dtype` are those of the
  engine Model the scene built."""

  def __init__(self, cfg: EntityCfg, mj_model, prefix: str, device,
               dtype=torch.float32):
    self.cfg = cfg
    self.idx = idx = compute_indexing(mj_model, prefix)
    self.device = torch.device(device)
    self._croot_body = int(mj_model.body_rootid[idx.root_body_id])
    self.is_fixed_base = idx.free_jnt_id < 0
    self.is_articulated = len(idx.joint_names) > 0
    self.is_actuated = len(idx.actuator_names) > 0
    t = lambda x: torch.tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=self.device)

    init = cfg.init_state
    self.default_root_state = t(list(init.pos) + list(init.rot)
                                + list(init.lin_vel) + list(init.ang_vel))
    nj = len(idx.joint_names)
    jp = np.zeros(nj)
    jv = np.zeros(nj)
    if nj:
      ids, _, vals = resolve_matching_names_values(
          init.joint_pos, idx.joint_names)
      jp[ids] = vals
      ids, _, vals = resolve_matching_names_values(
          init.joint_vel, idx.joint_names)
      jv[ids] = vals
    self.default_joint_pos = t(jp)
    self.default_joint_vel = t(jv)

    lim = (np.asarray(mj_model.jnt_range)[idx.jnt_ids] if nj
           else np.zeros((0, 2)))
    self.joint_pos_limits = t(lim)
    mid = 0.5 * (lim[:, 0] + lim[:, 1])
    half = 0.5 * (lim[:, 1] - lim[:, 0]) * cfg.soft_joint_pos_limit_factor
    self.soft_joint_pos_limits = t(np.stack([mid - half, mid + half], -1))
    if len(idx.ctrl_ids):
      self.joint_stiffness = t(
          np.asarray(mj_model.actuator_gainprm)[idx.ctrl_ids, 0])
      self.joint_damping = t(
          -np.asarray(mj_model.actuator_biasprm)[idx.ctrl_ids, 2])
      self.joint_effort_limits = t(
          np.asarray(mj_model.actuator_forcerange)[idx.ctrl_ids, 1])
    else:
      self.joint_stiffness = t(np.zeros(0))
      self.joint_damping = t(np.zeros(0))
      self.joint_effort_limits = t(np.zeros(0))

  def _ids(self, base: np.ndarray, sel=None) -> torch.Tensor:
    """Index tensor of `base`, or of its selection `sel` (a slice or an
    index array), from the table cache: no upload per call."""
    return ix(base if sel is None else base[sel], self.device)

  # ------------------------------------------------------------------
  # reads (batched data)
  # ------------------------------------------------------------------
  def root_pos_w(self, d: Data) -> torch.Tensor:
    return d.xpos[:, self.idx.root_body_id]

  def root_quat_w(self, d: Data) -> torch.Tensor:
    return d.xquat[:, self.idx.root_body_id]

  def _vel_at(self, d: Data, body, pos) -> torch.Tensor:
    """World-frame (lin, ang) velocity of body-fixed point(s).

    cvel is anchored at the origin of the c-frame: the subtree COM of the
    kinematic-root body."""
    cvel = d.cvel[:, body]
    ang = cvel[..., :3]
    com = d.subtree_com[:, self._croot_body]
    if cvel.ndim == 3:
      com = com[:, None, :]
    lin = cvel[..., 3:] + torch.linalg.cross(ang, pos - com, dim=-1)
    return torch.cat([lin, ang], dim=-1)

  def root_vel_w(self, d: Data) -> torch.Tensor:
    """(num_envs, 6): [lin_vel_w, ang_vel_w] at the root link frame."""
    return self._vel_at(d, self.idx.root_body_id,
                        d.xpos[:, self.idx.root_body_id])

  def root_lin_vel_w(self, d: Data) -> torch.Tensor:
    return self.root_vel_w(d)[:, :3]

  def root_ang_vel_w(self, d: Data) -> torch.Tensor:
    return d.cvel[:, self.idx.root_body_id, :3]

  def root_lin_vel_b(self, d: Data) -> torch.Tensor:
    return tmath.quat_apply_inverse(self.root_quat_w(d),
                                    self.root_lin_vel_w(d))

  def root_ang_vel_b(self, d: Data) -> torch.Tensor:
    return tmath.quat_apply_inverse(self.root_quat_w(d),
                                    self.root_ang_vel_w(d))

  def projected_gravity_b(self, d: Data) -> torch.Tensor:
    g = table(_DOWN, d.qpos.dtype, d.qpos.device)
    return tmath.quat_apply_inverse(self.root_quat_w(d), g)

  def heading_w(self, d: Data) -> torch.Tensor:
    q = self.root_quat_w(d)
    fwd = tmath.quat_apply(q, table(_FORWARD, q.dtype, q.device))
    return torch.atan2(fwd[:, 1], fwd[:, 0])

  def joint_pos(self, d: Data) -> torch.Tensor:
    return d.qpos[:, self._ids(self.idx.q_adr)]

  def joint_vel(self, d: Data) -> torch.Tensor:
    return d.qvel[:, self._ids(self.idx.v_adr)]

  def joint_acc(self, d: Data) -> torch.Tensor:
    return d.qacc[:, self._ids(self.idx.v_adr)]

  def actuator_force(self, d: Data) -> torch.Tensor:
    return d.actuator_force[:, self._ids(self.idx.ctrl_ids)]

  def applied_torque(self, d: Data) -> torch.Tensor:
    return d.qfrc_actuator[:, self._ids(self.idx.v_adr)]

  def body_pos_w(self, d: Data, body_ids=None) -> torch.Tensor:
    return d.xpos[:, self._ids(self.idx.body_ids, body_ids)]

  def body_quat_w(self, d: Data, body_ids=None) -> torch.Tensor:
    return d.xquat[:, self._ids(self.idx.body_ids, body_ids)]

  def body_vel_w(self, d: Data, body_ids=None) -> torch.Tensor:
    ids = self._ids(self.idx.body_ids, body_ids)
    return self._vel_at(d, ids, d.xpos[:, ids])

  def body_lin_vel_w(self, d: Data, body_ids=None) -> torch.Tensor:
    return self.body_vel_w(d, body_ids)[..., :3]

  def body_ang_vel_w(self, d: Data, body_ids=None) -> torch.Tensor:
    return d.cvel[:, self._ids(self.idx.body_ids, body_ids), :3]

  def geom_pos_w(self, d: Data, geom_ids=None) -> torch.Tensor:
    return d.geom_xpos[:, self._ids(self.idx.geom_ids, geom_ids)]

  def site_pos_w(self, d: Data, site_ids=None) -> torch.Tensor:
    return d.site_xpos[:, self._ids(self.idx.site_ids, site_ids)]

  def sensor_data(self, d: Data, name: str) -> torch.Tensor:
    for n, adr, dim in self.idx.sensor_map:
      if n == name:
        return d.sensordata[:, adr:adr + dim]
    raise KeyError(f'sensor {name!r} not on entity; '
                   f'available: {[n for n, _, _ in self.idx.sensor_map]}')

  # ------------------------------------------------------------------
  # writes (return new Data); `mask` selects envs (None = all)
  # ------------------------------------------------------------------
  @staticmethod
  def _masked_set(arr, cols, value, mask):
    """A copy of `arr` with `value` (a tensor on its device, or a Python
    number) in columns `cols` (an index tensor) of the masked envs."""
    new = arr.clone()
    if torch.is_tensor(value):
      new[:, cols] = value.to(arr.dtype)
    else:
      # a fill: assigning a Python number through an index would first
      # copy it to the device, and wait for the copy
      new.index_fill_(1, cols, value)
    if mask is None:
      return new
    return torch.where(mask.reshape((-1,) + (1,) * (arr.ndim - 1)), new, arr)

  def write_root_pose(self, d: Data, pose, mask=None) -> Data:
    if self.is_fixed_base:
      raise ValueError('cannot write root pose of fixed-base entity')
    return d.replace(qpos=self._masked_set(
        d.qpos, self._ids(self.idx.free_q_adr), pose, mask))

  def write_root_velocity(self, d: Data, vel, mask=None) -> Data:
    """Write (num_envs, 6) [lin_w, ang] into the free joint's qvel as
    given; MuJoCo keeps a free joint's angular velocity in the body-local
    frame."""
    if self.is_fixed_base:
      raise ValueError('cannot write root velocity of fixed-base entity')
    return d.replace(qvel=self._masked_set(
        d.qvel, self._ids(self.idx.free_v_adr), vel, mask))

  def write_root_state(self, d: Data, state, mask=None) -> Data:
    d = self.write_root_pose(d, state[:, :7], mask)
    return self.write_root_velocity(d, state[:, 7:13], mask)

  def write_joint_state(self, d: Data, pos, vel, joint_ids=None,
                        mask=None) -> Data:
    return d.replace(
        qpos=self._masked_set(d.qpos, self._ids(self.idx.q_adr, joint_ids),
                              pos, mask),
        qvel=self._masked_set(d.qvel, self._ids(self.idx.v_adr, joint_ids),
                              vel, mask))

  def write_joint_position_target(self, d: Data, target, joint_ids=None,
                                  mask=None) -> Data:
    """PD position targets -> ctrl."""
    return d.replace(ctrl=self._masked_set(
        d.ctrl, self._ids(self.idx.ctrl_ids, joint_ids), target, mask))

  def write_external_wrench(self, d: Data, force, torque, body_ids=None,
                            mask=None) -> Data:
    wrench = torch.cat([force, torque], dim=-1)
    return d.replace(xfrc_applied=self._masked_set(
        d.xfrc_applied, self._ids(self.idx.body_ids, body_ids), wrench, mask))

  def reset(self, d: Data, mask=None) -> Data:
    """Clear the external forces on the entity's bodies."""
    return d.replace(xfrc_applied=self._masked_set(
        d.xfrc_applied, self._ids(self.idx.body_ids), 0.0, mask))
