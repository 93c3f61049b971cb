"""Model / Data containers for the batched PyTorch physics engine.

Counterpart of mjlab_tpu/physics/types.py, in PyTorch idiom:

* `ModelStatic` holds everything that is fixed for a compiled model (sizes,
  tree topology, joint/geom types, the static collision pair table) as a
  host-side object of numpy arrays and ints. Python loops over its tables
  take the place of the JAX code's trace-time unrolling.
* `Model` holds the numeric model parameters as tensors on one device. It
  is shared by every env of a batch, but for the fields that domain
  randomization writes (sim.sim.PER_ENV_FIELDS), which may carry a leading
  env axis.
* `Data` is the dynamic state. Every tensor carries a leading env axis B:
  the engine is written natively batched (no vmap).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import numpy as np
import torch


class JointType(enum.IntEnum):
  FREE = 0
  BALL = 1
  SLIDE = 2
  HINGE = 3


class GeomType(enum.IntEnum):
  PLANE = 0
  HFIELD = 1
  SPHERE = 2
  CAPSULE = 3
  ELLIPSOID = 4
  CYLINDER = 5
  BOX = 6
  MESH = 7


class IntegratorType(enum.IntEnum):
  EULER = 0
  RK4 = 1
  IMPLICIT = 2
  IMPLICITFAST = 3


class ConeType(enum.IntEnum):
  PYRAMIDAL = 0
  ELLIPTIC = 1


class BiasType(enum.IntEnum):
  NONE = 0
  AFFINE = 1


class GainType(enum.IntEnum):
  FIXED = 0
  AFFINE = 1


class TrnType(enum.IntEnum):
  """Actuator transmissions (mjtTrn); the engine drives joints and
  tendons."""
  JOINT = 0
  TENDON = 3
  SITE = 4


class DisableBit(enum.IntFlag):
  CONSTRAINT = 1 << 0
  EQUALITY = 1 << 1
  FRICTIONLOSS = 1 << 2
  LIMIT = 1 << 3
  CONTACT = 1 << 4
  PASSIVE = 1 << 5
  GRAVITY = 1 << 6
  CLAMPCTRL = 1 << 7
  WARMSTART = 1 << 8
  ACTUATION = 1 << 10
  REFSAFE = 1 << 11
  SENSOR = 1 << 12
  EULERDAMP = 1 << 15


def _digest(x: Any) -> bytes:
  if isinstance(x, np.ndarray):
    return x.tobytes() + str(x.shape).encode() + str(x.dtype).encode()
  if isinstance(x, (list, tuple)):
    return b'[' + b','.join(_digest(v) for v in x) + b']'
  if isinstance(x, dict):
    return b'{' + b','.join(
        _digest(k) + b':' + _digest(v) for k, v in sorted(x.items())) + b'}'
  return repr(x).encode()


@dataclasses.dataclass(frozen=True, eq=False)
class StaticBase:
  """Frozen dataclass with a content hash, so static tables can key
  `functools.lru_cache` although they hold numpy arrays."""

  def _key(self) -> bytes:
    """Digest of every field, computed once: the object is frozen. A cache
    keyed on an equal but distinct object (a second Model of the same
    scene) compares keys on every lookup, so this must not be recomputed."""
    key = self.__dict__.get('_key_cache')
    if key is None:
      key = b'|'.join(
          _digest(getattr(self, f.name)) for f in dataclasses.fields(self))
      object.__setattr__(self, '_key_cache', key)
    return key

  def __hash__(self):
    h = self.__dict__.get('_hash_cache')
    if h is None:
      h = hash(self._key())
      object.__setattr__(self, '_hash_cache', h)
    return h

  def __eq__(self, other):
    return self is other or (type(self) is type(other)
                             and hash(self) == hash(other)
                             and self._key() == other._key())


@dataclasses.dataclass(frozen=True, eq=False)
class CollisionPairs(StaticBase):
  """Static narrowphase work lists grouped by collider key:
  (GeomType, GeomType) -> (geom1 ids, geom2 ids, pair ids (-1 = dynamic),
  first contact slot, contact points per pair)."""
  groups: dict
  ncon_max: int


@dataclasses.dataclass(frozen=True, eq=False)
class ModelStatic(StaticBase):
  # sizes
  nq: int
  nv: int
  nu: int
  nbody: int
  njnt: int
  ngeom: int
  nsite: int
  nsensor: int
  nsensordata: int

  # body topology
  body_parentid: np.ndarray
  body_rootid: np.ndarray
  body_jntadr: np.ndarray
  body_jntnum: np.ndarray
  body_dofadr: np.ndarray
  body_dofnum: np.ndarray
  body_geomadr: np.ndarray
  body_geomnum: np.ndarray
  body_levels: tuple  # bodies grouped by tree depth, world excluded
  ancestor_mask: np.ndarray  # (nbody, nv)
  subtree_mask: np.ndarray  # (nbody, nbody)
  dof_prefix_mask: np.ndarray  # (nv, nv)

  # joints
  jnt_type: np.ndarray
  jnt_qposadr: np.ndarray
  jnt_dofadr: np.ndarray
  jnt_bodyid: np.ndarray
  jnt_limited: np.ndarray
  jnt_actgravcomp: np.ndarray

  # dofs
  dof_bodyid: np.ndarray
  dof_jntid: np.ndarray

  # geoms
  geom_type: np.ndarray
  geom_bodyid: np.ndarray
  geom_condim: np.ndarray
  geom_priority: np.ndarray

  # sites
  site_bodyid: np.ndarray

  # actuators
  actuator_trntype: np.ndarray
  actuator_trnid: np.ndarray
  actuator_gaintype: np.ndarray
  actuator_biastype: np.ndarray
  actuator_ctrllimited: np.ndarray
  actuator_forcelimited: np.ndarray

  # sensors
  sensor_type: np.ndarray
  sensor_datatype: np.ndarray
  sensor_objtype: np.ndarray
  sensor_objid: np.ndarray
  sensor_reftype: np.ndarray
  sensor_refid: np.ndarray
  sensor_adr: np.ndarray
  sensor_dim: np.ndarray
  sensor_intprm: np.ndarray

  # options
  integrator: int
  cone: int
  iterations: int
  ls_iterations: int
  disableflags: int

  # collision
  pairs: CollisionPairs
  con_geom1: np.ndarray
  con_geom2: np.ndarray
  con_dim: np.ndarray

  body_names: tuple
  jnt_names: tuple
  geom_names: tuple
  site_names: tuple
  actuator_names: tuple
  sensor_names: tuple

  # contact compaction pools (see io.put_model): frictional slots
  # (condim > 1) and frictionless slots (condim == 1); 0 = no compaction
  ncon_cap: int = 0
  ncon_cap1: int = 0

  nmocap: int = 0
  body_mocapid: np.ndarray = None
  # actuator activation states (integrator / filter / filterexact)
  na: int = 0
  actuator_dyntype: np.ndarray = None  # (nu,) mjtDyn
  actuator_actadr: np.ndarray = None  # (nu,) act index, -1 = stateless
  actuator_actlimited: np.ndarray = None  # (nu,) bool
  # tendons: a fixed tendon (a joint coupling) is constant rows, L =
  # ten_coef_q @ qpos and J = ten_coef_v; a spatial tendon is a straight
  # chain of sites (wrapping geoms and pulleys raise in io.put_model)
  ntendon: int = 0
  ten_is_fixed: np.ndarray = None  # (max(ntendon, 1),) bool
  ten_coef_q: np.ndarray = None  # (max(ntendon, 1), nq)
  ten_coef_v: np.ndarray = None  # (max(ntendon, 1), nv)
  ten_site_chains: tuple = ()  # per tendon, its site ids (() if fixed)
  ten_limited: np.ndarray = None  # (max(ntendon, 1),) bool
  # equality constraints (connect, weld, joint): their rows lead the efc
  # rows, ahead of friction, limits and contacts (MuJoCo's order)
  neq: int = 0
  eq_type: np.ndarray = None  # (neq,) mjtEq
  eq_obj1: np.ndarray = None  # (neq,) body or joint id
  eq_obj2: np.ndarray = None

  # heightfield terrain (at most one hfield asset): generated rough terrain
  # collides as one hfield geom; Model.hfield_data holds its grid
  nhfield: int = 0
  hfield_nrow: int = 0
  hfield_ncol: int = 0
  hfield_size: np.ndarray = None  # (4,) radius_x, radius_y, elevation, base
  hfield_geomid: int = -1

  # mesh geoms collide as their convex hulls, padded and precomputed when
  # the model is built (physics/mesh.py; a visual-only mesh's rows stay
  # empty); a model without a collidable mesh has none
  geom_dataid: np.ndarray = None  # (ngeom,) mesh id, -1 for other geoms
  mesh_hulls: Any = None  # mesh.MeshHulls | None

  # Newton early exit: stop once |grad| < tolerance*meaninertia*max(1,nv)
  newton_tolerance: float = 1e-8
  meaninertia: float = 1.0


def _replace(self, **kwargs):
  return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class Option:
  timestep: torch.Tensor
  gravity: torch.Tensor  # (3,)
  impratio: torch.Tensor
  tolerance: torch.Tensor
  ls_tolerance: torch.Tensor

  replace = _replace


@dataclasses.dataclass
class Model:
  """Numeric model parameters, one copy for the whole batch; a field of
  sim.sim.PER_ENV_FIELDS may be (B, ...) instead, one row an env."""
  stat: ModelStatic
  opt: Option

  qpos0: torch.Tensor
  qpos_spring: torch.Tensor

  body_pos: torch.Tensor
  body_quat: torch.Tensor
  body_ipos: torch.Tensor
  body_iquat: torch.Tensor
  body_mass: torch.Tensor
  body_subtreemass: torch.Tensor
  body_inertia: torch.Tensor
  body_invweight0: torch.Tensor
  body_gravcomp: torch.Tensor

  jnt_pos: torch.Tensor
  jnt_axis: torch.Tensor
  jnt_range: torch.Tensor
  jnt_stiffness: torch.Tensor
  jnt_solref: torch.Tensor
  jnt_solimp: torch.Tensor
  jnt_margin: torch.Tensor

  dof_armature: torch.Tensor
  dof_damping: torch.Tensor
  dof_frictionloss: torch.Tensor
  dof_invweight0: torch.Tensor
  dof_solref: torch.Tensor
  dof_solimp: torch.Tensor

  geom_pos: torch.Tensor
  geom_quat: torch.Tensor
  geom_size: torch.Tensor
  geom_friction: torch.Tensor
  geom_solref: torch.Tensor
  geom_solimp: torch.Tensor
  geom_solmix: torch.Tensor
  geom_margin: torch.Tensor
  geom_gap: torch.Tensor
  geom_rgba: torch.Tensor

  site_pos: torch.Tensor
  site_quat: torch.Tensor

  actuator_gainprm: torch.Tensor
  actuator_biasprm: torch.Tensor
  actuator_gear: torch.Tensor
  actuator_ctrlrange: torch.Tensor
  actuator_forcerange: torch.Tensor
  actuator_dynprm: torch.Tensor  # (nu, 3), tau in [..., 0]
  actuator_actrange: torch.Tensor  # (nu, 2)

  pair_friction: torch.Tensor
  pair_solref: torch.Tensor
  pair_solimp: torch.Tensor
  pair_margin: torch.Tensor

  # heightfield elevations in meters, (hfield_nrow, hfield_ncol), rows
  # along y; (1, 1) zeros when the model has no hfield
  hfield_data: torch.Tensor

  # equality constraints; (1, ...) zeros when neq == 0
  eq_data: torch.Tensor  # (neq, 11)
  eq_solref: torch.Tensor  # (neq, 2)
  eq_solimp: torch.Tensor  # (neq, 5)
  eq_active0: torch.Tensor  # (neq,) 0 or 1

  # tendons; (1, ...) placeholders when ntendon == 0
  tendon_stiffness: torch.Tensor  # (ntendon,)
  tendon_damping: torch.Tensor
  tendon_lengthspring: torch.Tensor  # (ntendon, 2): the spring's deadband
  tendon_range: torch.Tensor  # (ntendon, 2)
  tendon_solref_lim: torch.Tensor  # (ntendon, 2)
  tendon_solimp_lim: torch.Tensor  # (ntendon, 5)
  tendon_margin: torch.Tensor
  tendon_invweight0: torch.Tensor

  replace = _replace

  @property
  def device(self) -> torch.device:
    return self.qpos0.device  # qpos0 may be (nq,) or per env (B, nq)

  @property
  def dtype(self) -> torch.dtype:
    return self.qpos0.dtype


@dataclasses.dataclass
class Contact:
  """Fixed-capacity contact set, (B, ncon, ...). Slot -> pair mapping is
  static (ModelStatic.pairs); inactive slots have dist >= includemargin."""
  dist: torch.Tensor  # (B, ncon)
  pos: torch.Tensor  # (B, ncon, 3)
  frame: torch.Tensor  # (B, ncon, 3, 3) rows: normal, t1, t2
  friction: torch.Tensor  # (B, ncon, 5)
  solref: torch.Tensor  # (B, ncon, 2)
  solimp: torch.Tensor  # (B, ncon, 5)
  includemargin: torch.Tensor  # (B, ncon)

  replace = _replace


@dataclasses.dataclass
class Data:
  """Batched dynamic state; every tensor has a leading env axis B."""
  qpos: torch.Tensor
  qvel: torch.Tensor
  ctrl: torch.Tensor
  qacc: torch.Tensor
  qacc_warmstart: torch.Tensor
  time: torch.Tensor  # (B,)
  xfrc_applied: torch.Tensor  # (B, nbody, 6)
  qfrc_applied: torch.Tensor

  xpos: torch.Tensor
  xquat: torch.Tensor
  xmat: torch.Tensor
  xipos: torch.Tensor
  ximat: torch.Tensor
  xanchor: torch.Tensor
  xaxis: torch.Tensor
  geom_xpos: torch.Tensor
  geom_xmat: torch.Tensor
  site_xpos: torch.Tensor
  site_xmat: torch.Tensor

  subtree_com: torch.Tensor
  cinr: torch.Tensor  # (B, nbody, 6, 6)
  cdof: torch.Tensor  # (B, nv, 6)
  cdof_dot: torch.Tensor
  cvel: torch.Tensor  # (B, nbody, 6)

  qM: torch.Tensor  # (B, nv, nv)
  qfrc_bias: torch.Tensor
  qfrc_passive: torch.Tensor
  qfrc_spring: torch.Tensor
  qfrc_damper: torch.Tensor
  qfrc_actuator: torch.Tensor
  qfrc_smooth: torch.Tensor
  qacc_smooth: torch.Tensor
  qfrc_constraint: torch.Tensor

  actuator_length: torch.Tensor
  actuator_velocity: torch.Tensor
  actuator_force: torch.Tensor

  contact: Contact
  efc_force: torch.Tensor  # (B, nefc)
  ncon_active: torch.Tensor  # (B,) int32
  solver_niter: torch.Tensor  # (B,) int32

  sensordata: torch.Tensor

  act: torch.Tensor  # (B, max(na, 1))
  act_dot: torch.Tensor

  # mocap poses, set by the caller and read by kinematics: (B, nmocap, 3)
  # and (B, nmocap, 4); (B, 1, .) placeholders without mocap bodies
  mocap_pos: torch.Tensor
  mocap_quat: torch.Tensor

  # tendon state; (B, 1) and (B, 1, nv) placeholders without tendons
  ten_length: torch.Tensor  # (B, ntendon)
  ten_velocity: torch.Tensor  # (B, ntendon)
  ten_J: torch.Tensor  # (B, ntendon, nv)

  replace = _replace

  @property
  def batch_size(self) -> int:
    return self.qpos.shape[0]
