"""Unitree Go1 flat-terrain velocity task.

Counterpart of mjlab_tpu/tasks/velocity/config/go1/flat_env_cfg.py. The
compiled scene (plane, Go1 with full collision and the four found-only
foot ground-contact sensors) is asset_zoo/go1_flat_scene.py's, loaded from
its committed snapshot.
"""

from __future__ import annotations

import dataclasses

from mjlab_torch.asset_zoo import go1_flat_arrays
from mjlab_torch.asset_zoo.unitree_go1 import (
    FOOT_REGEX,
    GO1_ACTION_SCALE,
    GO1_ROBOT_CFG,
)
from mjlab_torch.managers.term_cfg import SceneEntityCfg
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.tasks.velocity.velocity_env_cfg import (
    LocomotionVelocityEnvCfg,
)
from mjlab_torch.terrains.importer import TerrainImporterCfg

# posture-reward stds of the Go1 tuning
GO1_POSE_STD = {'.*_hip_joint': 0.3, '.*_thigh_joint': 0.5,
                '.*_calf_joint': 0.6}


@dataclasses.dataclass
class UnitreeGo1FlatEnvCfg(LocomotionVelocityEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 1024,
        terrain=TerrainImporterCfg(terrain_type='plane'),
        entities={'robot': dataclasses.replace(GO1_ROBOT_CFG)},
        model_fn=go1_flat_arrays)
    self.actions.joint_pos.scale = GO1_ACTION_SCALE
    self.events.foot_friction.params['asset_cfg'] = SceneEntityCfg(
        'robot', geom_names=[FOOT_REGEX])
    self.rewards.pose.params['std'] = GO1_POSE_STD
    self.rewards.flat_orientation_l2.weight = -2.5


@dataclasses.dataclass
class UnitreeGo1FlatEnvCfg_PLAY(UnitreeGo1FlatEnvCfg):

  def __post_init__(self):
    super().__post_init__()
    self.scene.num_envs = 16
    self.episode_length_s = 1e9
    self.observations.policy.enable_corruption = False
    self.events.push_robot = None
