"""The Unitree G1 flat-terrain velocity scene as a compiled MjModel.

Builds the physics model the velocity task `Mjlab-Velocity-Flat-Unitree-G1`
builds (mjlab_tpu/tasks/velocity/config/g1/flat_env_cfg.py): a plane named
`terrain`, the G1 under the prefix `robot/` with its position actuators
(PD gains at 10 Hz, damping ratio 2, armature from the reflected rotor
inertia of the Unitree motors), full collision (feet condim 3, priority 1,
friction 0.6; every other collision geom condim 1), two found-only foot
ground-contact sensors, the knees-bent keyframe, and the options
timestep=0.005, implicitfast, pyramidal cone, iterations=10,
ls_iterations=20, tolerance=1e-8. The visual mesh layer is left out.
"""

from __future__ import annotations

import re

import mujoco
import numpy as np

from mjlab_torch.asset_zoo.data.g1_spec_data import SPEC_DATA
from mjlab_torch.asset_zoo.spec_builder import build_robot_spec
from mjlab_torch.asset_zoo.unitree_g1 import (
    FOOT_REGEX,
    G1_ACTUATORS,
    KNEES_BENT_KEYFRAME,
)


def add_actuators(spec: mujoco.MjSpec, actuators) -> None:
  """One position servo per matched joint (gainprm[0] = kp, biasprm =
  (0, -kp, -kd), forcerange = +/-effort), in spec joint order.
  `actuators` holds (joint regexes, ElectricActuator, multiplier); the last
  matching motor class wins, as the JAX package's ActuatorSetCfg."""
  names = [j.name for j in spec.joints
           if j.type != mujoco.mjtJoint.mjJNT_FREE]
  chosen = {}
  for exprs, act, mult in actuators:
    pats = [re.compile(e) for e in exprs]
    for name in names:
      if any(p.match(name) for p in pats):
        chosen[name] = (act, mult)
  for name in names:
    if name not in chosen:
      continue
    act, mult = chosen[name]
    kp, kd = act.pd_gains()
    joint = spec.joint(name)
    joint.armature = act.reflected_inertia * mult
    joint.frictionloss = 0.0
    a = spec.add_actuator(
        name=name, target=name, trntype=mujoco.mjtTrn.mjTRN_JOINT,
        gaintype=mujoco.mjtGain.mjGAIN_FIXED,
        biastype=mujoco.mjtBias.mjBIAS_AFFINE, inheritrange=1.0,
        forcerange=(-act.effort_limit * mult, act.effort_limit * mult))
    a.gainprm[0] = kp * mult
    a.biasprm[1] = -kp * mult
    a.biasprm[2] = -kd * mult


def _full_collision(spec: mujoco.MjSpec) -> None:
  """Every '.*_collision' geom collides (self-collision included): feet
  condim 3, priority 1, friction 0.6; the rest condim 1. Other geoms are
  made non-colliding."""
  foot = re.compile(FOOT_REGEX)
  coll = re.compile('.*_collision')
  for g in spec.geoms:
    if g.name and coll.match(g.name):
      g.contype = 1
      g.conaffinity = 1
      is_foot = bool(foot.match(g.name))
      g.condim = 3 if is_foot else 1
      g.priority = 1 if is_foot else 0
      if is_foot:
        g.friction[0] = 0.6
    else:
      g.contype = 0
      g.conaffinity = 0


def _foot_contact_sensors(spec: mujoco.MjSpec) -> None:
  """Ground contact of each foot subtree, found-only, netforce reduce."""
  for side in ('left', 'right'):
    spec.add_sensor(
        name=f'{side}_foot_ground_contact',
        type=mujoco.mjtSensor.mjSENS_CONTACT,
        objtype=mujoco.mjtObj.mjOBJ_XBODY,
        objname=f'{side}_ankle_roll_link',
        reftype=mujoco.mjtObj.mjOBJ_GEOM, refname='terrain',
        intprm=[1, 3, 1])


def add_keyframe(spec: mujoco.MjSpec, kf) -> None:
  """'init_state' keyframe of the EntityInitStateCfg `kf`: qpos = [pos,
  rot, joint_pos], ctrl = the joint targets."""
  names = [j.name for j in spec.joints
           if j.type != mujoco.mjtJoint.mjJNT_FREE]
  jp = np.zeros(len(names))
  pats = [(re.compile(k), v) for k, v in kf.joint_pos.items()]
  for i, name in enumerate(names):
    hits = [v for p, v in pats if p.fullmatch(name)]
    if len(hits) > 1:
      raise ValueError(f'{name} matched by several keyframe patterns')
    if hits:
      jp[i] = hits[0]
  qpos = np.concatenate([kf.pos, kf.rot, jp])
  key = spec.add_key(name='init_state', qpos=qpos)
  key.ctrl = jp


def robot_spec(add_sensors=_foot_contact_sensors) -> mujoco.MjSpec:
  """The G1 with its actuators, full collision, the sensors that
  `add_sensors(spec)` adds (the velocity tasks' foot contacts by default)
  and the knees-bent keyframe."""
  spec = build_robot_spec(SPEC_DATA)
  add_actuators(spec, G1_ACTUATORS)
  _full_collision(spec)
  add_sensors(spec)
  add_keyframe(spec, KNEES_BENT_KEYFRAME)
  return spec


def flat_scene_spec(robot: mujoco.MjSpec, generator=None) -> mujoco.MjSpec:
  """A plane named `terrain`, `robot` attached under the prefix `robot/`,
  and the velocity tasks' simulation options. With a TerrainGenerator
  `generator`, its heightfield geom named `terrain` takes the plane's
  place (the rough scenes)."""
  spec = mujoco.MjSpec()
  spec.stat.extent = 4.0
  if generator is None:
    spec.worldbody.add_geom(
        name='terrain', type=mujoco.mjtGeom.mjGEOM_PLANE,
        size=[0.0, 0.0, 0.05], rgba=[0.2, 0.3, 0.4, 1.0])
  else:
    generator.build(spec)
  frame = spec.worldbody.add_frame()
  spec.attach(robot, prefix='robot/', frame=frame)
  opt = spec.option
  opt.timestep = 0.005
  opt.integrator = mujoco.mjtIntegrator.mjINT_IMPLICITFAST
  opt.cone = mujoco.mjtCone.mjCONE_PYRAMIDAL
  opt.impratio = 1.0
  opt.iterations = 10
  opt.tolerance = 1e-8
  opt.ls_iterations = 20
  opt.ls_tolerance = 0.01
  opt.gravity = (0.0, 0.0, -9.81)
  return spec


def g1_flat_model() -> mujoco.MjModel:
  """The compiled G1 flat scene."""
  return flat_scene_spec(robot_spec()).compile()


def write_snapshot() -> None:
  """Write the committed ModelArrays snapshot of the compiled scene."""
  from mjlab_torch.asset_zoo import G1_FLAT_SNAPSHOT
  from mjlab_torch.physics.io import ModelArrays
  ModelArrays.of(g1_flat_model()).save(G1_FLAT_SNAPSHOT)


if __name__ == '__main__':
  write_snapshot()
