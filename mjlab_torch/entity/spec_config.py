"""Declarative MjSpec editors (build time, on a host with mujoco).

Counterpart of mjlab_tpu/entity/spec_config.py: PD actuator synthesis,
collision property rewriting, sensors (the contact sensor among them),
lights, cameras, textures and materials. The dataclasses need no mujoco
package, so every task cfg that holds them imports on a GPU host without
it; each `edit_spec` imports mujoco when it runs.

PD actuators: a position servo per matched joint with gainprm[0] = kp,
biasprm = (0, -kp, -kd), forcerange = +/-effort, inheritrange 1, and the
joint's armature and frictionloss set from its cfg. Where several cfgs
match a joint the last one wins; actuators are added in spec joint order.

A field given as a {regex: value} dict resolves per name: the regexes
match at the start of the name, and the first matching one wins
(utils/string.py:resolve_prefix_value), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

from mjlab_torch.utils.string import filter_exp, resolve_prefix_value

# mujoco enum members by name, looked up when an editor runs
_SENSOR_TYPES = {
    'gyro': 'mjSENS_GYRO',
    'velocimeter': 'mjSENS_VELOCIMETER',
    'accelerometer': 'mjSENS_ACCELEROMETER',
    'framequat': 'mjSENS_FRAMEQUAT',
    'framepos': 'mjSENS_FRAMEPOS',
    'framelinvel': 'mjSENS_FRAMELINVEL',
    'frameangvel': 'mjSENS_FRAMEANGVEL',
    'framezaxis': 'mjSENS_FRAMEZAXIS',
    'upvector': 'mjSENS_FRAMEZAXIS',
    'contact': 'mjSENS_CONTACT',
    'subtreeangmom': 'mjSENS_SUBTREEANGMOM',
}
_OBJ_TYPES = {
    'body': 'mjOBJ_BODY',
    'xbody': 'mjOBJ_XBODY',
    'geom': 'mjOBJ_GEOM',
    'site': 'mjOBJ_SITE',
}
_CONTACT_DATA = {
    'found': 0, 'force': 1, 'torque': 2, 'dist': 3, 'pos': 4,
    'normal': 5, 'tangent': 6,
}
_CONTACT_REDUCE = {'none': 0, 'mindist': 1, 'maxforce': 2, 'netforce': 3}


def _obj(kind: str):
  import mujoco
  return getattr(mujoco.mjtObj, _OBJ_TYPES[kind])


@dataclasses.dataclass
class SpecCfg:
  """Base class: anything that edits an MjSpec."""

  def edit_spec(self, spec) -> None:
    raise NotImplementedError


@dataclasses.dataclass
class ActuatorCfg:
  joint_names_expr: list[str]
  effort_limit: float
  stiffness: float
  damping: float
  frictionloss: float = 0.0
  armature: float = 0.0


@dataclasses.dataclass
class ActuatorSetCfg(SpecCfg):
  cfgs: tuple[ActuatorCfg, ...]

  def edit_spec(self, spec) -> None:
    import mujoco
    joints = [j for j in spec.joints
              if j.type not in (mujoco.mjtJoint.mjJNT_FREE,)]
    joint_names = [j.name for j in joints]
    chosen: dict[str, ActuatorCfg] = {}
    any_match = False
    for cfg in self.cfgs:
      if cfg.effort_limit <= 0:
        raise ValueError('effort_limit must be positive')
      if cfg.stiffness < 0 or cfg.damping < 0:
        raise ValueError('stiffness/damping must be non-negative')
      matched = filter_exp(cfg.joint_names_expr, joint_names)
      if not matched:
        continue
      any_match = True
      for name in matched:
        chosen[name] = cfg  # the last matching cfg wins
    if self.cfgs and not any_match:
      raise ValueError(
          f'no joints matched actuator patterns; available: {joint_names}')
    for name in joint_names:
      if name not in chosen:
        continue
      cfg = chosen[name]
      joint = spec.joint(name)
      if joint.range[0] >= joint.range[1]:
        raise ValueError(f'joint {name} must be limited for position control')
      joint.armature = cfg.armature
      joint.frictionloss = cfg.frictionloss
      act = spec.add_actuator(
          name=name, target=name,
          trntype=mujoco.mjtTrn.mjTRN_JOINT,
          gaintype=mujoco.mjtGain.mjGAIN_FIXED,
          biastype=mujoco.mjtBias.mjBIAS_AFFINE,
          inheritrange=1.0,
          forcerange=(-cfg.effort_limit, cfg.effort_limit))
      act.gainprm[0] = cfg.stiffness
      act.biasprm[1] = -cfg.stiffness
      act.biasprm[2] = -cfg.damping


@dataclasses.dataclass
class CollisionCfg(SpecCfg):
  """Rewrite the collision properties of the matched geoms (in the order
  of the spec's geoms); by default make every other geom non-colliding."""
  geom_names_expr: list[str]
  contype: 'int | dict' = 1
  conaffinity: 'int | dict' = 1
  condim: 'int | dict' = 3
  priority: 'int | dict' = 0
  friction: 'tuple | dict | None' = None
  solref: 'tuple | dict | None' = None
  solimp: 'tuple | dict | None' = None
  disable_other_geoms: bool = True

  def edit_spec(self, spec) -> None:
    geom_names = [g.name for g in spec.geoms if g.name]
    matched_set = set(filter_exp(self.geom_names_expr, geom_names))
    for g in spec.geoms:
      if g.name in matched_set:
        for field in ('contype', 'conaffinity', 'condim', 'priority'):
          val = resolve_prefix_value(getattr(self, field), g.name)
          if val is not None:
            setattr(g, field, val)
        for field in ('friction', 'solref', 'solimp'):
          val = resolve_prefix_value(getattr(self, field), g.name)
          if val is not None:
            arr = getattr(g, field)
            for i, v in enumerate(val):
              arr[i] = v
      elif self.disable_other_geoms:
        g.contype = 0
        g.conaffinity = 0


@dataclasses.dataclass
class SensorCfg(SpecCfg):
  name: str
  sensor_type: str
  objtype: Literal['body', 'xbody', 'geom', 'site']
  objname: str
  reftype: 'str | None' = None
  refname: 'str | None' = None

  def edit_spec(self, spec) -> None:
    import mujoco
    sns = spec.add_sensor(
        name=self.name,
        type=getattr(mujoco.mjtSensor, _SENSOR_TYPES[self.sensor_type]),
        objtype=_obj(self.objtype), objname=self.objname)
    if self.reftype is not None and self.refname is not None:
      sns.reftype = _obj(self.reftype)
      sns.refname = self.refname


@dataclasses.dataclass
class ContactSensorCfg(SpecCfg):
  """An mjSENS_CONTACT sensor over a geom, body or subtree pair. Its width
  is `num` times the channels of `data`: the found-only default is one
  column, which the port's sensor reader relies on."""
  name: str
  geom1: 'str | None' = None
  body1: 'str | None' = None
  subtree1: 'str | None' = None
  geom2: 'str | None' = None
  body2: 'str | None' = None
  subtree2: 'str | None' = None
  num: int = 1
  data: 'tuple[str, ...]' = ('found',)
  reduce: Literal['none', 'mindist', 'maxforce', 'netforce'] = 'none'

  def edit_spec(self, spec) -> None:
    import mujoco
    primary = [(self.geom1, 'geom'), (self.body1, 'body'),
               (self.subtree1, 'xbody')]
    primary = [(n, t) for n, t in primary if n is not None]
    if len(primary) != 1:
      raise ValueError('exactly one of geom1/body1/subtree1 required')
    secondary = [(self.geom2, 'geom'), (self.body2, 'body'),
                 (self.subtree2, 'xbody')]
    secondary = [(n, t) for n, t in secondary if n is not None]
    if len(secondary) > 1:
      raise ValueError('at most one of geom2/body2/subtree2')
    if self.num <= 0:
      raise ValueError('num must be positive')
    dataspec = sum(1 << _CONTACT_DATA[k] for k in self.data) or 1
    kwargs = dict(
        name=self.name,
        type=mujoco.mjtSensor.mjSENS_CONTACT,
        objtype=_obj(primary[0][1]),
        objname=primary[0][0],
        intprm=[dataspec, _CONTACT_REDUCE[self.reduce], self.num])
    if secondary:
      kwargs['reftype'] = _obj(secondary[0][1])
      kwargs['refname'] = secondary[0][0]
    spec.add_sensor(**kwargs)


@dataclasses.dataclass
class LightCfg(SpecCfg):
  name: 'str | None' = None
  body: str = 'world'
  mode: str = 'fixed'
  target: 'str | None' = None
  type: Literal['spot', 'directional'] = 'spot'
  castshadow: bool = True
  pos: tuple = (0, 0, 0)
  dir: tuple = (0, 0, -1)

  def edit_spec(self, spec) -> None:
    import mujoco
    body = spec.worldbody if self.body == 'world' else spec.body(self.body)
    mode = getattr(mujoco.mjtCamLight, f'mjCAMLIGHT_{self.mode.upper()}')
    light = body.add_light(
        mode=mode, pos=self.pos, dir=self.dir, castshadow=self.castshadow,
        type=(mujoco.mjtLightType.mjLIGHT_DIRECTIONAL
              if self.type == 'directional' else
              mujoco.mjtLightType.mjLIGHT_SPOT))
    if self.name:
      light.name = self.name
    if self.target:
      light.targetbody = self.target


@dataclasses.dataclass
class CameraCfg(SpecCfg):
  name: str
  body: str = 'world'
  mode: str = 'fixed'
  target: 'str | None' = None
  fovy: float = 45
  pos: tuple = (0, 0, 0)
  quat: tuple = (1, 0, 0, 0)

  def edit_spec(self, spec) -> None:
    import mujoco
    body = spec.worldbody if self.body == 'world' else spec.body(self.body)
    mode = getattr(mujoco.mjtCamLight, f'mjCAMLIGHT_{self.mode.upper()}')
    cam = body.add_camera(name=self.name, mode=mode, fovy=self.fovy,
                          pos=self.pos, quat=self.quat)
    if self.target:
      cam.targetbody = self.target


@dataclasses.dataclass
class TextureCfg(SpecCfg):
  name: str
  type: Literal['2d', 'cube', 'skybox']
  builtin: Literal['checker', 'gradient', 'flat', 'none']
  rgb1: tuple
  rgb2: tuple
  width: int
  height: int
  mark: Literal['edge', 'cross', 'random', 'none'] = 'none'
  markrgb: tuple = (0.0, 0.0, 0.0)

  def edit_spec(self, spec) -> None:
    import mujoco
    spec.add_texture(
        name=self.name,
        type=getattr(mujoco.mjtTexture, f'mjTEXTURE_{self.type.upper()}'),
        builtin=getattr(mujoco.mjtBuiltin,
                        f'mjBUILTIN_{self.builtin.upper()}'),
        mark=getattr(mujoco.mjtMark, f'mjMARK_{self.mark.upper()}'),
        rgb1=self.rgb1, rgb2=self.rgb2, markrgb=self.markrgb,
        width=self.width, height=self.height)


@dataclasses.dataclass
class MaterialCfg(SpecCfg):
  name: str
  texuniform: bool
  texrepeat: tuple
  reflectance: float = 0.0
  texture: 'str | None' = None

  def edit_spec(self, spec) -> None:
    import mujoco
    mat = spec.add_material(name=self.name, texuniform=self.texuniform,
                            texrepeat=self.texrepeat,
                            reflectance=self.reflectance)
    if self.texture is not None:
      mat.textures[mujoco.mjtTextureRole.mjTEXROLE_RGB.value] = self.texture
