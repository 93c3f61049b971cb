"""The Unitree G1 flat-terrain motion-tracking scene as a compiled MjModel.

Builds the physics model the tracking task `Mjlab-Tracking-Flat-Unitree-G1`
builds (mjlab_tpu/tasks/tracking/config/g1/flat_env_cfg.py): the G1 flat
velocity scene of g1_flat_scene.py (plane, actuators, full collision with
self-collision, knees-bent keyframe, the velocity tasks' options) with one
contact sensor in place of the two foot-ground sensors: `self_collision`,
the subtree of `pelvis` against itself, found-only, netforce reduce, 10
contacts. The visual mesh layer is left out.

    python -m mjlab_torch.asset_zoo.g1_tracking_scene

writes the committed snapshot asset_zoo/data/g1_tracking_model.npz.
"""

from __future__ import annotations

import mujoco

from mjlab_torch.asset_zoo.g1_flat_scene import flat_scene_spec, robot_spec

FOUND, NETFORCE = 1, 3  # contact sensor dataspec bit, reduce mode


def _self_collision_sensor(spec: mujoco.MjSpec) -> None:
  spec.add_sensor(
      name='self_collision', type=mujoco.mjtSensor.mjSENS_CONTACT,
      objtype=mujoco.mjtObj.mjOBJ_XBODY, objname='pelvis',
      reftype=mujoco.mjtObj.mjOBJ_XBODY, refname='pelvis',
      intprm=[FOUND, NETFORCE, 10])


def g1_tracking_model() -> mujoco.MjModel:
  """The compiled G1 tracking scene."""
  return flat_scene_spec(robot_spec(_self_collision_sensor)).compile()


def write_snapshot() -> None:
  """Write the committed ModelArrays snapshot of the compiled scene."""
  from mjlab_torch.asset_zoo import G1_TRACKING_SNAPSHOT
  from mjlab_torch.physics.io import ModelArrays
  ModelArrays.of(g1_tracking_model()).save(G1_TRACKING_SNAPSHOT)


if __name__ == '__main__':
  write_snapshot()
