"""Unitree G1 rough-terrain velocity task.

Counterpart of mjlab_tpu/tasks/velocity/config/g1/rough_env_cfg.py. The
scene is the G1 flat task's robot on the terrain generator's heightfield;
its compiled model is asset_zoo/rough_scene.py's (the G1 flat snapshot
with the heightfield, regenerated from the generator's seed, in place of
the plane) while the robot's spec inputs are the snapshot's.
"""

from __future__ import annotations

import dataclasses

from mjlab_torch.asset_zoo.rough_scene import g1_rough_arrays
from mjlab_torch.asset_zoo.unitree_g1 import FOOT_REGEX, G1_ACTION_SCALE
from mjlab_torch.managers.term_cfg import SceneEntityCfg
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.tasks.velocity.config.g1.flat_env_cfg import (
    G1_POSE_STD,
    g1_with_sensors,
)
from mjlab_torch.tasks.velocity.velocity_env_cfg import (
    LocomotionVelocityRoughEnvCfg,
    make_rough_terrain_cfg,
)


@dataclasses.dataclass
class UnitreeG1RoughEnvCfg(LocomotionVelocityRoughEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 1024,
        terrain=make_rough_terrain_cfg(),
        entities={'robot': g1_with_sensors()},
        model_fn=g1_rough_arrays)
    super().__post_init__()
    self.actions.joint_pos.scale = G1_ACTION_SCALE
    self.events.foot_friction.params['asset_cfg'] = SceneEntityCfg(
        'robot', geom_names=[FOOT_REGEX])
    self.rewards.pose.params['std'] = G1_POSE_STD
    # the G1 runs without the command-velocity curriculum
    self.curriculum.command_vel = None
    self.rewards.air_time.params['sensor_names'] = (
        'left_foot_ground_contact', 'right_foot_ground_contact')


@dataclasses.dataclass
class UnitreeG1RoughEnvCfg_PLAY(UnitreeG1RoughEnvCfg):

  def __post_init__(self):
    super().__post_init__()
    self.scene.num_envs = 16
    # a smaller terrain for playback
    gen = self.scene.terrain.terrain_generator
    gen.num_rows = 3
    gen.num_cols = 4
    gen.border_width = 6.0
    gen.curriculum = False
    self.episode_length_s = 1e9
    self.observations.policy.enable_corruption = False
    self.events.push_robot = None
