"""Unitree G1 flat-terrain velocity task.

Counterpart of mjlab_tpu/tasks/velocity/config/g1/flat_env_cfg.py. The
scene is a plane and the G1 with full collision and two found-only foot
ground-contact sensors (ground contact only: under full collision a foot
can also touch the other leg, which must not read as touchdown). Its
compiled model is the committed snapshot asset_zoo/data/g1_flat_model.npz
while the cfg's spec inputs are the snapshot's (scene/scene.py;
`python -m mjlab_torch.scene.snapshot` rewrites it).
"""

from __future__ import annotations

import dataclasses

from mjlab_torch.asset_zoo import g1_flat_arrays
from mjlab_torch.asset_zoo.unitree_g1 import (
    FOOT_REGEX,
    G1_ACTION_SCALE,
    G1_ROBOT_CFG,
)
from mjlab_torch.entity.spec_config import ContactSensorCfg
from mjlab_torch.managers.term_cfg import SceneEntityCfg
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.tasks.velocity.velocity_env_cfg import (
    LocomotionVelocityEnvCfg,
)
from mjlab_torch.terrains.importer import TerrainImporterCfg

# posture-reward stds of the G1 tuning
G1_POSE_STD = {
    '.*hip_pitch.*': 0.3, '.*hip_roll.*': 0.15, '.*hip_yaw.*': 0.15,
    '.*knee.*': 0.35, '.*ankle_pitch.*': 0.25, '.*ankle_roll.*': 0.1,
    '.*waist_yaw.*': 0.15, '.*waist_roll.*': 0.08, '.*waist_pitch.*': 0.1,
    '.*shoulder_pitch.*': 0.35, '.*shoulder_roll.*': 0.15,
    '.*shoulder_yaw.*': 0.1, '.*elbow.*': 0.25, '.*wrist.*': 0.3,
}


def g1_with_sensors():
  """The G1 entity with the velocity tasks' two foot ground-contact
  sensors (found-only: no term reads the force channel)."""
  cfg = dataclasses.replace(G1_ROBOT_CFG)
  cfg.spec_editors = cfg.spec_editors + tuple(
      ContactSensorCfg(name=f'{side}_foot_ground_contact',
                       subtree1=f'{side}_ankle_roll_link', geom2='terrain',
                       data=('found',), reduce='netforce')
      for side in ('left', 'right'))
  return cfg


@dataclasses.dataclass
class UnitreeG1FlatEnvCfg(LocomotionVelocityEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 1024,
        terrain=TerrainImporterCfg(terrain_type='plane'),
        entities={'robot': g1_with_sensors()},
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


@dataclasses.dataclass
class UnitreeG1FlatEnvCfg_PLAY(UnitreeG1FlatEnvCfg):

  def __post_init__(self):
    super().__post_init__()
    self.scene.num_envs = 16
    self.episode_length_s = 1e9
    self.observations.policy.enable_corruption = False
    self.events.push_robot = None
