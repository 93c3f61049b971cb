"""The TinyBot flat scene as a compiled MjModel.

Builds the physics model that the Tiny tasks `Mjlab-Velocity-Flat-Tiny`
and `Mjlab-Tracking-Flat-Tiny` build (mjlab_tpu/tasks/{velocity,tracking}/
config/tiny.py; both compile the same scene): a plane named `terrain`, the
TinyBot (asset_zoo/tiny_bot.py) under the prefix `robot/`, and the options
of the velocity tasks (g1_flat_scene.flat_scene_spec). `Mjlab-Velocity-
Rough-Tiny` puts the terrain generator's heightfield in the plane's place
(asset_zoo/rough_scene.py).

    python -m mjlab_torch.asset_zoo.tiny_scene

writes the committed snapshot asset_zoo/data/tiny_flat_model.npz.
"""

from __future__ import annotations

import mujoco

from mjlab_torch.asset_zoo.g1_flat_scene import flat_scene_spec
from mjlab_torch.asset_zoo.tiny_bot import robot_spec


def tiny_flat_model() -> mujoco.MjModel:
  """The compiled TinyBot flat scene."""
  return flat_scene_spec(robot_spec()).compile()


def write_snapshot() -> None:
  """Write the committed ModelArrays snapshot of the compiled scene."""
  from mjlab_torch.asset_zoo import TINY_FLAT_SNAPSHOT
  from mjlab_torch.physics.io import ModelArrays
  ModelArrays.of(tiny_flat_model()).save(TINY_FLAT_SNAPSHOT)


if __name__ == '__main__':
  write_snapshot()
