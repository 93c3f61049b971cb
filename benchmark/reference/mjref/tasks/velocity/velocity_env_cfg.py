"""Locomotion velocity-tracking task MDP, on flat and on rough terrain.

Counterpart of mjlab_tpu/tasks/velocity/velocity_env_cfg.py. Robot-specific
configs (tasks/velocity/config/{g1,go1}) specialize the scene, the action
scale, the posture stds and the geoms whose friction is randomized.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import field

from mjref.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjref.managers.term_cfg import (
    CurriculumTermCfg as CurrTerm,
    EventTermCfg as EventTerm,
    ObservationGroupCfg as ObsGroup,
    ObservationTermCfg as ObsTerm,
    RewardTermCfg as RewardTerm,
    SceneEntityCfg,
    TerminationTermCfg as DoneTerm,
    term,
)
from mjref.scene.scene import SceneCfg
from mjref.sim.sim import MujocoCfg, SimulationCfg
from mjref.tasks.velocity import mdp
from mjref.tasks.velocity.mdp.velocity_command import Ranges
from mjref.terrains.importer import TerrainImporterCfg
from mjref.utils.noise import UniformNoiseCfg as Unoise


@dataclasses.dataclass
class ActionCfg:
  joint_pos: mdp.JointPositionActionCfg = term(
      mdp.JointPositionActionCfg,
      asset_name='robot', joint_names=['.*'], scale=0.5,
      use_default_offset=True)


@dataclasses.dataclass
class CommandsCfg:
  twist: mdp.UniformVelocityCommandCfg = term(
      mdp.UniformVelocityCommandCfg,
      asset_name='robot',
      resampling_time_range=(3.0, 8.0),
      rel_standing_envs=0.1,
      rel_heading_envs=1.0,
      heading_command=True,
      heading_control_stiffness=0.5,
      ranges=Ranges(
          lin_vel_x=(-1.0, 1.0), lin_vel_y=(-0.5, 0.5),
          ang_vel_z=(-1.0, 1.0), heading=(-math.pi, math.pi)))


@dataclasses.dataclass
class ObservationCfg:

  @dataclasses.dataclass
  class PolicyCfg(ObsGroup):
    base_lin_vel: ObsTerm = term(
        ObsTerm, func=mdp.base_lin_vel, noise=Unoise(n_min=-0.1, n_max=0.1))
    base_ang_vel: ObsTerm = term(
        ObsTerm, func=mdp.base_ang_vel, noise=Unoise(n_min=-0.2, n_max=0.2))
    projected_gravity: ObsTerm = term(
        ObsTerm, func=mdp.projected_gravity,
        noise=Unoise(n_min=-0.05, n_max=0.05))
    joint_pos: ObsTerm = term(
        ObsTerm, func=mdp.joint_pos_rel,
        noise=Unoise(n_min=-0.01, n_max=0.01))
    joint_vel: ObsTerm = term(
        ObsTerm, func=mdp.joint_vel_rel, noise=Unoise(n_min=-1.5, n_max=1.5))
    actions: ObsTerm = term(ObsTerm, func=mdp.last_action)
    command: ObsTerm = term(ObsTerm, func=mdp.generated_commands,
                            params={'command_name': 'twist'})

    def __post_init__(self):
      self.enable_corruption = True

  @dataclasses.dataclass
  class PrivilegedCfg(PolicyCfg):
    def __post_init__(self):
      self.enable_corruption = False

  policy: PolicyCfg = field(default_factory=PolicyCfg)
  critic: PrivilegedCfg = field(default_factory=PrivilegedCfg)


@dataclasses.dataclass
class EventCfg:
  reset_base: EventTerm = term(
      EventTerm, func=mdp.reset_root_state_uniform, mode='reset',
      params={'pose_range': {'x': (-0.5, 0.5), 'y': (-0.5, 0.5),
                             'yaw': (-3.14, 3.14)},
              'velocity_range': {}})
  reset_robot_joints: EventTerm = term(
      EventTerm, func=mdp.reset_joints_by_scale, mode='reset',
      params={'position_range': (1.0, 1.0), 'velocity_range': (0.0, 0.0),
              'asset_cfg': SceneEntityCfg('robot', joint_names=['.*'])})
  push_robot: EventTerm = term(
      EventTerm, func=mdp.push_by_setting_velocity, mode='interval',
      interval_range_s=(1.0, 3.0),
      params={'velocity_range': {'x': (-1.0, 1.0), 'y': (-1.0, 1.0)}})
  foot_friction: EventTerm = term(
      EventTerm, func=mdp.randomize_field, mode='startup',
      params={'asset_cfg': SceneEntityCfg('robot', geom_names=[]),
              'operation': 'abs', 'field': 'geom_friction',
              'ranges': (0.3, 1.2)})


@dataclasses.dataclass
class RewardCfg:
  track_lin_vel_exp: RewardTerm = term(
      RewardTerm, func=mdp.track_lin_vel_exp, weight=1.0,
      params={'command_name': 'twist', 'std': math.sqrt(0.25)})
  track_ang_vel_exp: RewardTerm = term(
      RewardTerm, func=mdp.track_ang_vel_exp, weight=1.0,
      params={'command_name': 'twist', 'std': math.sqrt(0.25)})
  pose: RewardTerm = term(
      RewardTerm, func=mdp.posture, weight=1.0,
      params={'asset_cfg': SceneEntityCfg('robot', joint_names=['.*']),
              'std': {}})
  dof_pos_limits: RewardTerm = term(
      RewardTerm, func=mdp.joint_pos_limits, weight=-1.0)
  action_rate_l2: RewardTerm = term(
      RewardTerm, func=mdp.action_rate_l2, weight=-0.1)
  flat_orientation_l2: RewardTerm = term(
      RewardTerm, func=mdp.flat_orientation_l2, weight=0.0)
  # off by default; robot cfgs fill sensor_names
  air_time: RewardTerm = term(
      RewardTerm, func=mdp.feet_air_time, weight=0.0,
      params={'asset_name': 'robot', 'threshold_min': 0.05,
              'threshold_max': 0.15, 'command_name': 'twist',
              'command_threshold': 0.05, 'sensor_names': (),
              'reward_mode': 'on_landing'})


@dataclasses.dataclass
class TerminationCfg:
  time_out: DoneTerm = term(DoneTerm, func=mdp.time_out, time_out=True)
  fell_over: DoneTerm = term(
      DoneTerm, func=mdp.bad_orientation,
      params={'limit_angle': math.radians(70.0)})


@dataclasses.dataclass
class CurriculumCfg:
  command_vel: 'CurrTerm | None' = term(
      CurrTerm, func=mdp.commands_vel,
      params={'command_name': 'twist', 'base_range': (-1.0, 1.0),
              'velocity_stages': [{'step': 500 * 24, 'range': (-3.0, 3.0)}]})
  # set by the rough-terrain variant
  terrain_levels: 'CurrTerm | None' = None


SIM_CFG = SimulationCfg(
    mujoco=MujocoCfg(timestep=0.005, iterations=10, ls_iterations=20))


def _sim_cfg() -> SimulationCfg:
  """A copy of SIM_CFG for each env cfg: an override of one env's
  `sim.*` reaches neither SIM_CFG nor another env."""
  return copy.deepcopy(SIM_CFG)


@dataclasses.dataclass
class LocomotionVelocityEnvCfg(ManagerBasedRlEnvCfg):
  scene: SceneCfg = field(default_factory=lambda: SceneCfg(
      num_envs=1024, terrain=TerrainImporterCfg(terrain_type='plane')))
  observations: ObservationCfg = field(default_factory=ObservationCfg)
  actions: ActionCfg = field(default_factory=ActionCfg)
  rewards: RewardCfg = field(default_factory=RewardCfg)
  events: EventCfg = field(default_factory=EventCfg)
  terminations: TerminationCfg = field(default_factory=TerminationCfg)
  commands: CommandsCfg = field(default_factory=CommandsCfg)
  curriculum: CurriculumCfg = field(default_factory=CurriculumCfg)
  sim: SimulationCfg = field(default_factory=_sim_cfg)
  decimation: int = 4  # 50 Hz control
  episode_length_s: float = 20.0


def make_rough_terrain_cfg() -> TerrainImporterCfg:
  """Generator terrain on a copy of the default rough grid."""
  from mjref.terrains.config import ROUGH_TERRAINS_CFG
  return TerrainImporterCfg(
      terrain_type='generator',
      terrain_generator=copy.deepcopy(ROUGH_TERRAINS_CFG))


@dataclasses.dataclass
class LocomotionVelocityRoughEnvCfg(LocomotionVelocityEnvCfg):
  """Rough-terrain variant: the procedural stairs grid and the
  walked-distance terrain-level curriculum."""

  def __post_init__(self):
    self.scene.terrain = make_rough_terrain_cfg()
    self.curriculum.terrain_levels = CurrTerm(
        func=mdp.terrain_levels_vel,
        params={'command_name': 'twist',
                'asset_cfg': SceneEntityCfg('robot')})
