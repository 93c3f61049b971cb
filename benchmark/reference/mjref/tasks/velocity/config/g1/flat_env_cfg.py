"""Unitree G1 flat-terrain velocity task.

Counterpart of mjlab_tpu/tasks/velocity/config/g1/flat_env_cfg.py. The
scene is a plane and the G1 with full collision and two found-only foot
ground-contact sensors (ground contact only: under full collision a foot
can also touch the other leg, which must not read as touchdown). Its
compiled model is the pinned snapshot benchmark/reference/data/
g1_flat_model.npz, which holds them.
"""

from __future__ import annotations

import dataclasses

from mjref.asset_zoo import g1_flat_arrays
from mjref.asset_zoo.unitree_g1 import (
    FOOT_REGEX,
    G1_ACTION_SCALE,
    G1_ROBOT_CFG,
)
from mjref.managers.term_cfg import SceneEntityCfg
from mjref.scene.scene import SceneCfg
from mjref.tasks.velocity.velocity_env_cfg import (
    LocomotionVelocityEnvCfg,
)
from mjref.terrains.importer import TerrainImporterCfg

# posture-reward stds of the G1 tuning
G1_POSE_STD = {
    '.*hip_pitch.*': 0.3, '.*hip_roll.*': 0.15, '.*hip_yaw.*': 0.15,
    '.*knee.*': 0.35, '.*ankle_pitch.*': 0.25, '.*ankle_roll.*': 0.1,
    '.*waist_yaw.*': 0.15, '.*waist_roll.*': 0.08, '.*waist_pitch.*': 0.1,
    '.*shoulder_pitch.*': 0.35, '.*shoulder_roll.*': 0.15,
    '.*shoulder_yaw.*': 0.1, '.*elbow.*': 0.25, '.*wrist.*': 0.3,
}


@dataclasses.dataclass
class UnitreeG1FlatEnvCfg(LocomotionVelocityEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 1024,
        terrain=TerrainImporterCfg(terrain_type='plane'),
        entities={'robot': dataclasses.replace(G1_ROBOT_CFG)},
        model_fn=g1_flat_arrays)
    self.actions.joint_pos.scale = G1_ACTION_SCALE
    self.events.foot_friction.params['asset_cfg'] = SceneEntityCfg(
        'robot', geom_names=[FOOT_REGEX])
    self.rewards.pose.params['std'] = G1_POSE_STD
    # the G1 runs without the command-velocity curriculum, and the flat
    # variant softens the pushes
    self.curriculum.command_vel = None
    self.events.push_robot.params['velocity_range'] = {
        'x': (-0.5, 0.5), 'y': (-0.5, 0.5)}
