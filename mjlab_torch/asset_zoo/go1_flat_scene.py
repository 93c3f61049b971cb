"""The Unitree Go1 flat-terrain velocity scene as a compiled MjModel.

Builds the physics model the velocity task `Mjlab-Velocity-Flat-Unitree-Go1`
builds (mjlab_tpu/tasks/velocity/config/go1/flat_env_cfg.py): a plane named
`terrain`, the Go1 under the prefix `robot/` with one position servo per
joint, the full collision preset (every collision geom collides with the
world and not with the robot itself; feet condim 3, priority 1, friction
0.6, solimp (0.9, 0.95, 0.023); every other collision geom condim 1), four
found-only foot ground-contact sensors, the standing keyframe, and the
options of the velocity tasks (flat_scene_spec). The visual mesh layer is
left out.

    python -m mjlab_torch.asset_zoo.go1_flat_scene

writes the committed snapshot asset_zoo/data/go1_flat_model.npz.
"""

from __future__ import annotations

import re

import mujoco

from mjlab_torch.asset_zoo.data.go1_spec_data import SPEC_DATA
from mjlab_torch.asset_zoo.g1_flat_scene import (
    add_actuators,
    add_keyframe,
    flat_scene_spec,
)
from mjlab_torch.asset_zoo.spec_builder import build_robot_spec
from mjlab_torch.asset_zoo.unitree_go1 import (
    FOOT_REGEX,
    GO1_ACTUATORS,
    INIT_STATE,
)

FEET = ('FL', 'FR', 'RL', 'RR')


def _full_collision(spec: mujoco.MjSpec) -> None:
  """Every '.*_collision' geom gets contype 1 and conaffinity 0, so it
  collides with the terrain and not with another robot geom; feet condim
  3, priority 1, friction 0.6 and solimp (0.9, 0.95, 0.023), the rest
  condim 1. Other geoms are made non-colliding."""
  foot = re.compile(FOOT_REGEX)
  coll = re.compile('.*_collision')
  for g in spec.geoms:
    if g.name and coll.match(g.name):
      g.contype = 1
      g.conaffinity = 0
      if foot.match(g.name):
        g.condim = 3
        g.priority = 1
        g.friction[0] = 0.6
        g.solimp[:3] = (0.9, 0.95, 0.023)
      else:
        g.condim = 1
    else:
      g.contype = 0
      g.conaffinity = 0


def _foot_contact_sensors(spec: mujoco.MjSpec) -> None:
  """Each foot geom against the terrain, found-only, netforce reduce."""
  for p in FEET:
    spec.add_sensor(
        name=f'{p}_foot_ground_contact',
        type=mujoco.mjtSensor.mjSENS_CONTACT,
        objtype=mujoco.mjtObj.mjOBJ_GEOM, objname=f'{p}_foot_collision',
        reftype=mujoco.mjtObj.mjOBJ_GEOM, refname='terrain',
        intprm=[1, 3, 1])


def robot_spec() -> mujoco.MjSpec:
  spec = build_robot_spec(SPEC_DATA)
  add_actuators(spec, GO1_ACTUATORS)
  _full_collision(spec)
  _foot_contact_sensors(spec)
  add_keyframe(spec, INIT_STATE)
  return spec


def go1_flat_model() -> mujoco.MjModel:
  """The compiled Go1 flat scene."""
  return flat_scene_spec(robot_spec()).compile()


def write_snapshot() -> None:
  """Write the committed ModelArrays snapshot of the compiled scene."""
  from mjlab_torch.asset_zoo import GO1_FLAT_SNAPSHOT
  from mjlab_torch.physics.io import ModelArrays
  ModelArrays.of(go1_flat_model()).save(GO1_FLAT_SNAPSHOT)


if __name__ == '__main__':
  write_snapshot()
