"""TinyBot velocity tasks: fast smoke and debug tasks.

Counterpart of mjlab_tpu/tasks/velocity/config/tiny.py. Not part of the
reference task surface, so the registry does not import this module; opt
in with MJLAB_TASKS_MODULES=mjlab_torch.tasks.velocity.config.tiny. The
full manager stack of the velocity task on a 2-DoF robot with five
floor-contact geoms: the compiled scene is asset_zoo/tiny_scene.py's,
loaded from its committed snapshot (the rough task's heightfield comes
from asset_zoo/rough_scene.py).
"""

from __future__ import annotations

import dataclasses

from mjlab_torch.asset_zoo import tiny_flat_arrays
from mjlab_torch.asset_zoo.tiny_bot import TINY_ACTION_SCALE, TINY_ROBOT_CFG
from mjlab_torch.managers.term_cfg import CurriculumTermCfg, SceneEntityCfg
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.tasks import registry
from mjlab_torch.tasks.velocity.velocity_env_cfg import (
    LocomotionVelocityEnvCfg,
    make_rough_terrain_cfg,
)
from mjlab_torch.terrains.importer import TerrainImporterCfg

FOOT_REGEX = r'^foot[0-3]_collision$'


@dataclasses.dataclass
class TinyVelocityEnvCfg(LocomotionVelocityEnvCfg):

  def __post_init__(self):
    self.scene = SceneCfg(
        num_envs=self.scene.num_envs if self.scene else 4,
        terrain=TerrainImporterCfg(terrain_type='plane'),
        entities={'robot': dataclasses.replace(TINY_ROBOT_CFG)},
        model_fn=tiny_flat_arrays)
    self.actions.joint_pos.scale = TINY_ACTION_SCALE
    self.events.foot_friction.params['asset_cfg'] = SceneEntityCfg(
        'robot', geom_names=[FOOT_REGEX])
    self.rewards.pose.params['std'] = {'.*': 0.5}
    self.curriculum.command_vel = None
    self.episode_length_s = 10.0


def _rl_cfg():
  from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg
  return RslRlOnPolicyRunnerCfg(experiment_name='tiny_velocity',
                                save_interval=50, max_iterations=100)


registry.register('Mjlab-Velocity-Flat-Tiny',
                  env_cfg_entry_point=TinyVelocityEnvCfg,
                  rl_cfg_entry_point=_rl_cfg)


@dataclasses.dataclass
class TinyVelocityRoughEnvCfg(TinyVelocityEnvCfg):
  """Generator terrain and the terrain-level curriculum on the TinyBot:
  the heightfield colliders and the curriculum without a full robot."""

  def __post_init__(self):
    super().__post_init__()
    from mjlab_torch.asset_zoo.rough_scene import tiny_rough_arrays
    from mjlab_torch.tasks.velocity import mdp
    self.scene.terrain = make_rough_terrain_cfg()
    self.scene.model_fn = tiny_rough_arrays
    self.curriculum.terrain_levels = CurriculumTermCfg(
        func=mdp.terrain_levels_vel,
        params={'command_name': 'twist',
                'asset_cfg': SceneEntityCfg('robot')})


registry.register('Mjlab-Velocity-Rough-Tiny',
                  env_cfg_entry_point=TinyVelocityRoughEnvCfg,
                  rl_cfg_entry_point=_rl_cfg)
