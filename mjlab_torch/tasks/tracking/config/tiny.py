"""TinyBot tracking task: a fast smoke and debug task.

Counterpart of mjlab_tpu/tasks/tracking/config/tiny.py. Not part of the
reference task surface, so the registry does not import this module; opt
in with MJLAB_TASKS_MODULES=mjlab_torch.tasks.tracking.config.tiny. The
whole tracking stack (the motion loader, RSI resets, adaptive sampling,
the anchor and body tracking rewards and terminations) on the 2-DoF
TinyBot, on a clip that `write_tiny_motion` authors through the same CSV
pipeline as real clips (scripts/motion.py csv_to_npz). The caller sets
`commands.motion.motion_file`: the task has no default clip.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from mjlab_torch.asset_zoo import tiny_flat_arrays
from mjlab_torch.asset_zoo.tiny_bot import TINY_ACTION_SCALE, TINY_ROBOT_CFG
from mjlab_torch.managers.term_cfg import SceneEntityCfg
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.tasks import registry
from mjlab_torch.tasks.tracking.tracking_env_cfg import TrackingEnvCfg
from mjlab_torch.terrains.importer import TerrainImporterCfg

TRACKED_BODIES = ('base', 'upper_arm', 'forearm')
ANCHOR_BODY = 'base'


def write_tiny_motion(npz_path: str, duration_s: float = 2.0,
                      csv_fps: float = 30.0, output_fps: float = 50.0,
                      csv_path: 'str | None' = None, device='cuda') -> str:
  """Author a TinyBot 'arm wave' clip through the CSV pipeline: the base
  at rest, sinusoidal shoulder and elbow. The CSV goes to `csv_path`,
  else beside `npz_path`. Returns npz_path."""
  from mjlab_torch.scripts.motion import csv_to_npz

  t = np.arange(int(duration_s * csv_fps)) / csv_fps
  base = np.tile(np.asarray([0.0, 0.0, 0.075, 1.0, 0.0, 0.0, 0.0]),
                 (len(t), 1))
  joints = np.stack([0.4 * np.sin(2 * np.pi * t / duration_s),
                     0.3 * np.cos(2 * np.pi * t / duration_s) - 0.3], -1)
  rows = np.concatenate([base, joints], -1)
  csv = csv_path or os.path.splitext(npz_path)[0] + '.csv'
  np.savetxt(csv, rows, delimiter=',')
  csv_to_npz(csv, npz_path, input_fps=csv_fps, output_fps=output_fps,
             mj_model=tiny_flat_arrays(), device=device)
  return npz_path


@dataclasses.dataclass
class TinyTrackingEnvCfg(TrackingEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 4,
        terrain=TerrainImporterCfg(terrain_type='plane'),
        entities={'robot': dataclasses.replace(TINY_ROBOT_CFG)},
        model_fn=tiny_flat_arrays)
    self.actions.joint_pos.scale = TINY_ACTION_SCALE
    cmd = self.commands.motion
    cmd.anchor_body_name = ANCHOR_BODY
    cmd.body_names = TRACKED_BODIES
    self.terminations.ee_body_pos.params['body_names'] = ['forearm']
    self.events.foot_friction.params['asset_cfg'] = SceneEntityCfg(
        'robot', geom_names=[r'^foot[0-3]_collision$'])
    self.events.com_randomize.params['asset_cfg'] = SceneEntityCfg(
        'robot', body_names=['base'])
    self.events.qpos0_randomize.params['asset_cfg'] = SceneEntityCfg(
        'robot', joint_names=['shoulder', 'elbow'])
    # the TinyBot has no self-collision pairs, hence no such sensor
    self.rewards.self_collisions = None
    self.episode_length_s = 4.0


def _rl_cfg():
  from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg
  return RslRlOnPolicyRunnerCfg(experiment_name='tiny_tracking',
                                save_interval=50, max_iterations=100)


registry.register('Mjlab-Tracking-Flat-Tiny',
                  env_cfg_entry_point=TinyTrackingEnvCfg,
                  rl_cfg_entry_point=_rl_cfg)
