"""Motion-tracking (BeyondMimic-style) task MDP on flat terrain.

Counterpart of mjlab_tpu/tasks/tracking/tracking_env_cfg.py, field for
field. Robot-specific configs (tasks/tracking/config/g1) name the motion,
the anchor and tracked bodies, the end effectors and the randomized geoms,
bodies and joints.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import field

from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjlab_torch.managers.term_cfg import (
    EventTermCfg as EventTerm,
    ObservationGroupCfg as ObsGroup,
    ObservationTermCfg as ObsTerm,
    RewardTermCfg as RewTerm,
    SceneEntityCfg,
    TerminationTermCfg as DoneTerm,
    term,
)
from mjlab_torch.scene.scene import SceneCfg
from mjlab_torch.sim.sim import MujocoCfg, SimulationCfg
from mjlab_torch.tasks.tracking import mdp
from mjlab_torch.terrains.importer import TerrainImporterCfg
from mjlab_torch.utils.noise import UniformNoiseCfg as Unoise

VELOCITY_RANGE = {
    'x': (-0.5, 0.5), 'y': (-0.5, 0.5), 'z': (-0.2, 0.2),
    'roll': (-0.52, 0.52), 'pitch': (-0.52, 0.52), 'yaw': (-0.78, 0.78),
}


@dataclasses.dataclass
class CommandsCfg:
  motion: mdp.MotionCommandCfg = term(
      mdp.MotionCommandCfg,
      asset_name='robot',
      resampling_time_range=(1.0e9, 1.0e9),
      pose_range={'x': (-0.05, 0.05), 'y': (-0.05, 0.05),
                  'z': (-0.01, 0.01), 'roll': (-0.1, 0.1),
                  'pitch': (-0.1, 0.1), 'yaw': (-0.2, 0.2)},
      velocity_range=VELOCITY_RANGE,
      joint_position_range=(-0.1, 0.1),
      motion_file='', anchor_body_name='', body_names=())


@dataclasses.dataclass
class ActionCfg:
  joint_pos: mdp.JointPositionActionCfg = term(
      mdp.JointPositionActionCfg, asset_name='robot', joint_names=['.*'],
      scale=0.5, use_default_offset=True)


@dataclasses.dataclass
class ObservationCfg:

  @dataclasses.dataclass
  class PolicyCfg(ObsGroup):
    command: ObsTerm = term(ObsTerm, func=mdp.generated_commands,
                            params={'command_name': 'motion'})
    motion_anchor_pos_b: ObsTerm = term(
        ObsTerm, func=mdp.motion_anchor_pos_b,
        params={'command_name': 'motion'},
        noise=Unoise(n_min=-0.25, n_max=0.25))
    motion_anchor_ori_b: ObsTerm = term(
        ObsTerm, func=mdp.motion_anchor_ori_b,
        params={'command_name': 'motion'},
        noise=Unoise(n_min=-0.05, n_max=0.05))
    base_lin_vel: ObsTerm = term(
        ObsTerm, func=mdp.base_lin_vel, noise=Unoise(n_min=-0.5, n_max=0.5))
    base_ang_vel: ObsTerm = term(
        ObsTerm, func=mdp.base_ang_vel, noise=Unoise(n_min=-0.2, n_max=0.2))
    joint_pos: ObsTerm = term(
        ObsTerm, func=mdp.joint_pos_rel,
        noise=Unoise(n_min=-0.01, n_max=0.01))
    joint_vel: ObsTerm = term(
        ObsTerm, func=mdp.joint_vel_rel, noise=Unoise(n_min=-1.5, n_max=1.5))
    actions: ObsTerm = term(ObsTerm, func=mdp.last_action)

    def __post_init__(self):
      self.enable_corruption = True

  @dataclasses.dataclass
  class PrivilegedCfg(PolicyCfg):
    robot_body_pos: ObsTerm = term(ObsTerm, func=mdp.robot_body_pos_b,
                                   params={'command_name': 'motion'})
    robot_body_ori: ObsTerm = term(ObsTerm, func=mdp.robot_body_ori_b,
                                   params={'command_name': 'motion'})

    def __post_init__(self):
      self.enable_corruption = False

  policy: PolicyCfg = field(default_factory=PolicyCfg)
  critic: PrivilegedCfg = field(default_factory=PrivilegedCfg)


@dataclasses.dataclass
class EventCfg:
  # RSI: the motion's reference state written on reset
  reset_to_motion: EventTerm = term(
      EventTerm, func=mdp.reset_to_motion, mode='reset',
      params={'command_name': 'motion'})
  push_robot: EventTerm = term(
      EventTerm, func=mdp.push_by_setting_velocity, mode='interval',
      interval_range_s=(10.0, 15.0),
      params={'velocity_range': VELOCITY_RANGE})
  # startup domain randomization
  foot_friction: EventTerm = term(
      EventTerm, func=mdp.randomize_field, mode='startup',
      params={'asset_cfg': SceneEntityCfg('robot', geom_names=[]),
              'operation': 'abs', 'field': 'geom_friction',
              'ranges': (0.3, 1.2)})
  com_randomize: EventTerm = term(
      EventTerm, func=mdp.randomize_field, mode='startup',
      params={'asset_cfg': SceneEntityCfg('robot', body_names=[]),
              'operation': 'add', 'field': 'body_ipos',
              'ranges': (-0.01, 0.01)})
  qpos0_randomize: EventTerm = term(
      EventTerm, func=mdp.randomize_field, mode='startup',
      params={'asset_cfg': SceneEntityCfg('robot', joint_names=[]),
              'operation': 'add', 'field': 'qpos0',
              'ranges': (-0.01, 0.01)})


@dataclasses.dataclass
class RewardCfg:
  motion_global_root_pos: RewTerm = term(
      RewTerm, func=mdp.motion_global_anchor_position_error_exp, weight=0.5,
      params={'command_name': 'motion', 'std': 0.3})
  motion_global_root_ori: RewTerm = term(
      RewTerm, func=mdp.motion_global_anchor_orientation_error_exp,
      weight=0.5, params={'command_name': 'motion', 'std': 0.4})
  motion_body_pos: RewTerm = term(
      RewTerm, func=mdp.motion_relative_body_position_error_exp, weight=1.0,
      params={'command_name': 'motion', 'std': 0.3})
  motion_body_ori: RewTerm = term(
      RewTerm, func=mdp.motion_relative_body_orientation_error_exp,
      weight=1.0, params={'command_name': 'motion', 'std': 0.4})
  motion_body_lin_vel: RewTerm = term(
      RewTerm, func=mdp.motion_global_body_linear_velocity_error_exp,
      weight=1.0, params={'command_name': 'motion', 'std': 1.0})
  motion_body_ang_vel: RewTerm = term(
      RewTerm, func=mdp.motion_global_body_angular_velocity_error_exp,
      weight=1.0, params={'command_name': 'motion', 'std': 3.14})
  action_rate_l2: RewTerm = term(RewTerm, func=mdp.action_rate_l2,
                                 weight=-1e-1)
  joint_limit: RewTerm = term(
      RewTerm, func=mdp.joint_pos_limits, weight=-10.0,
      params={'asset_cfg': SceneEntityCfg('robot', joint_names=['.*'])})
  self_collisions: RewTerm = term(
      RewTerm, func=mdp.self_collision_cost, weight=-10.0,
      params={'sensor_name': 'self_collision'})


@dataclasses.dataclass
class TerminationsCfg:
  time_out: DoneTerm = term(DoneTerm, func=mdp.time_out, time_out=True)
  anchor_pos: DoneTerm = term(
      DoneTerm, func=mdp.bad_anchor_pos_z_only,
      params={'command_name': 'motion', 'threshold': 0.25})
  anchor_ori: DoneTerm = term(
      DoneTerm, func=mdp.bad_anchor_ori,
      params={'asset_cfg': SceneEntityCfg('robot'),
              'command_name': 'motion', 'threshold': 0.8})
  ee_body_pos: DoneTerm = term(
      DoneTerm, func=mdp.bad_motion_body_pos_z_only,
      params={'command_name': 'motion', 'threshold': 0.25,
              'body_names': []})


SIM_CFG = SimulationCfg(
    mujoco=MujocoCfg(timestep=0.005, iterations=10, ls_iterations=20))


def _sim_cfg() -> SimulationCfg:
  """A copy of SIM_CFG for each env cfg: an override of one env's
  `sim.*` reaches neither SIM_CFG nor another env."""
  return copy.deepcopy(SIM_CFG)


@dataclasses.dataclass
class TrackingEnvCfg(ManagerBasedRlEnvCfg):
  scene: SceneCfg = field(default_factory=lambda: SceneCfg(
      num_envs=1024, terrain=TerrainImporterCfg(terrain_type='plane')))
  observations: ObservationCfg = field(default_factory=ObservationCfg)
  actions: ActionCfg = field(default_factory=ActionCfg)
  commands: CommandsCfg = field(default_factory=CommandsCfg)
  rewards: RewardCfg = field(default_factory=RewardCfg)
  terminations: TerminationsCfg = field(default_factory=TerminationsCfg)
  events: EventCfg = field(default_factory=EventCfg)
  sim: SimulationCfg = field(default_factory=_sim_cfg)
  decimation: int = 4
  episode_length_s: float = 10.0
