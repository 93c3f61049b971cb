"""Unitree Go1 rough-terrain velocity task.

Counterpart of mjlab_tpu/tasks/velocity/config/go1/rough_env_cfg.py. The
scene is the Go1 flat task's robot on the terrain generator's heightfield;
its compiled model is asset_zoo/rough_scene.py's (the Go1 flat snapshot
with the heightfield in place of the plane) while the robot's spec inputs
are the snapshot's.
"""

from __future__ import annotations

import dataclasses

from mjlab_torch.asset_zoo.rough_scene import go1_rough_arrays
from mjlab_torch.asset_zoo.unitree_go1 import FOOT_REGEX, GO1_ACTION_SCALE
from mjlab_torch.managers.term_cfg import SceneEntityCfg
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.tasks.velocity.config.go1.flat_env_cfg import (
    GO1_FEET,
    GO1_POSE_STD,
    go1_with_sensors,
)
from mjlab_torch.tasks.velocity.velocity_env_cfg import (
    LocomotionVelocityRoughEnvCfg,
    make_rough_terrain_cfg,
)


@dataclasses.dataclass
class UnitreeGo1RoughEnvCfg(LocomotionVelocityRoughEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 1024,
        terrain=make_rough_terrain_cfg(),
        entities={'robot': go1_with_sensors()},
        model_fn=go1_rough_arrays)
    super().__post_init__()
    self.actions.joint_pos.scale = GO1_ACTION_SCALE
    self.events.foot_friction.params['asset_cfg'] = SceneEntityCfg(
        'robot', geom_names=[FOOT_REGEX])
    self.rewards.pose.params['std'] = GO1_POSE_STD
    self.rewards.flat_orientation_l2.weight = 0.0
    self.rewards.air_time.params['sensor_names'] = tuple(
        f'{p}_foot_ground_contact' for p in GO1_FEET)


@dataclasses.dataclass
class UnitreeGo1RoughEnvCfg_PLAY(UnitreeGo1RoughEnvCfg):

  def __post_init__(self):
    super().__post_init__()
    self.scene.num_envs = 16
    gen = self.scene.terrain.terrain_generator
    gen.num_rows = 3
    gen.num_cols = 4
    gen.border_width = 6.0
    gen.curriculum = False
    self.episode_length_s = 1e9
    self.observations.policy.enable_corruption = False
    self.events.push_robot = None
