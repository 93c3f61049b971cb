"""Unitree G1 motion-tracking task on flat terrain.

Counterpart of mjlab_tpu/tasks/tracking/config/g1/flat_env_cfg.py. The
compiled scene (plane, G1 with full collision and the `self_collision`
contact sensor) is asset_zoo/g1_tracking_scene.py's, loaded from its
committed snapshot. The default motion is a synthetic squat written on
first use by the port's scripts/motion.py into the port's motion cache
(`$MJLAB_TORCH_CACHE`, else build/motions/ at the repository root); real
motions come from its csv_to_npz, and the shipped policy's walk clip ships
beside it (asset_zoo/pretrained/g1_tracking/).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

from mjlab_torch.asset_zoo import tracking_arrays
from mjlab_torch.asset_zoo.unitree_g1 import (
    FOOT_REGEX,
    G1_ACTION_SCALE,
    G1_ROBOT_CFG,
)
from mjlab_torch.managers.term_cfg import SceneEntityCfg
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.tasks.tracking.tracking_env_cfg import TrackingEnvCfg
from mjlab_torch.terrains.importer import TerrainImporterCfg

TRACKED_BODIES = (
    'pelvis',
    'left_hip_roll_link', 'left_knee_link', 'left_ankle_roll_link',
    'right_hip_roll_link', 'right_knee_link', 'right_ankle_roll_link',
    'torso_link',
    'left_shoulder_roll_link', 'left_elbow_link', 'left_wrist_yaw_link',
    'right_shoulder_roll_link', 'right_elbow_link', 'right_wrist_yaw_link',
)
EE_BODIES = ['left_ankle_roll_link', 'right_ankle_roll_link',
             'left_wrist_yaw_link', 'right_wrist_yaw_link']
ANCHOR_BODY = 'torso_link'
MOTION_CACHE = Path(__file__).resolve().parents[5] / 'build' / 'motions'


def default_motion_file() -> str:
  """The synthetic G1 squat clip, written on first use. Its forward
  kinematics of 400 frames run on the CPU, the host the cfg is built on,
  as the JAX package runs CPU MuJoCo's."""
  from mjlab_torch.scripts.motion import (
      G1_MOTION_VERSION,
      generate_g1_squat_motion,
  )
  cache = Path(os.environ.get('MJLAB_TORCH_CACHE', MOTION_CACHE))
  path = cache / f'g1_squat_50hz_v{G1_MOTION_VERSION}.npz'
  if not path.exists():
    cache.mkdir(parents=True, exist_ok=True)
    # written under a name of its own, then renamed: processes that
    # build the cfg at once never read a half-written file
    tmp = cache / f'{path.stem}.{os.getpid()}.tmp.npz'
    generate_g1_squat_motion(str(tmp), device='cpu')
    os.replace(tmp, path)
  return str(path)


@dataclasses.dataclass
class G1FlatEnvCfg(TrackingEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 1024,
        terrain=TerrainImporterCfg(terrain_type='plane'),
        entities={'robot': dataclasses.replace(G1_ROBOT_CFG)},
        model_fn=tracking_arrays)
    self.actions.joint_pos.scale = G1_ACTION_SCALE
    cmd = self.commands.motion
    cmd.motion_file = default_motion_file()
    cmd.anchor_body_name = ANCHOR_BODY
    cmd.body_names = TRACKED_BODIES
    self.terminations.ee_body_pos.params['body_names'] = EE_BODIES
    self.events.foot_friction.params['asset_cfg'] = SceneEntityCfg(
        'robot', geom_names=[FOOT_REGEX])
    self.events.com_randomize.params['asset_cfg'] = SceneEntityCfg(
        'robot', body_names=['torso_link'])
    self.events.qpos0_randomize.params['asset_cfg'] = SceneEntityCfg(
        'robot', joint_names=['.*'])


def _no_state_estimation(cfg) -> None:
  """No anchor position and no base linear velocity in the policy's
  observation."""
  cfg.observations.policy.motion_anchor_pos_b = None
  cfg.observations.policy.base_lin_vel = None


def _play(cfg) -> None:
  """A few envs, no noise, no pushes, no RSI randomization, starts at the
  clip's first frame, episodes without end."""
  cfg.scene.num_envs = 4
  cfg.observations.policy.enable_corruption = False
  cfg.events.push_robot = None
  motion = cfg.commands.motion
  motion.pose_range = {}
  motion.velocity_range = {}
  motion.joint_position_range = (0.0, 0.0)
  motion.disable_adaptive_sampling = True
  cfg.episode_length_s = int(1e9)


@dataclasses.dataclass
class G1FlatNoStateEstimationEnvCfg(G1FlatEnvCfg):

  def __post_init__(self):
    super().__post_init__()
    _no_state_estimation(self)


@dataclasses.dataclass
class G1FlatNoStateEstimationEnvCfg_PLAY(G1FlatNoStateEstimationEnvCfg):

  def __post_init__(self):
    super().__post_init__()
    _play(self)


@dataclasses.dataclass
class G1FlatEnvCfg_PLAY(G1FlatEnvCfg):

  def __post_init__(self):
    super().__post_init__()
    _play(self)
