"""Unitree G1 rough-terrain velocity task.

Counterpart of mjlab_tpu/tasks/velocity/config/g1/rough_env_cfg.py. The
scene is the G1 flat task's robot on the terrain generator's heightfield;
its compiled model is asset_zoo/rough_scene.py's (the G1 flat snapshot
with the heightfield, regenerated from the generator's seed, in place of
the plane).
"""

from __future__ import annotations

import dataclasses

from mjref.asset_zoo.rough_scene import g1_rough_arrays
from mjref.asset_zoo.unitree_g1 import (
    FOOT_REGEX,
    G1_ACTION_SCALE,
    G1_ROBOT_CFG,
)
from mjref.managers.term_cfg import SceneEntityCfg
from mjref.scene.scene import SceneCfg
from mjref.tasks.velocity.config.g1.flat_env_cfg import G1_POSE_STD
from mjref.tasks.velocity.velocity_env_cfg import (
    LocomotionVelocityRoughEnvCfg,
    make_rough_terrain_cfg,
)


@dataclasses.dataclass
class UnitreeG1RoughEnvCfg(LocomotionVelocityRoughEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 1024,
        terrain=make_rough_terrain_cfg(),
        entities={'robot': dataclasses.replace(G1_ROBOT_CFG)},
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
