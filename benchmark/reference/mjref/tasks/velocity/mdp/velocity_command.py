"""Uniform velocity command generator.

Counterpart of mjlab_tpu/tasks/velocity/mdp/velocity_command.py."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mjref.managers.command_manager import CommandTerm
from mjref.managers.term_cfg import CommandTermCfg
from mjref.utils import math as tmath


@dataclasses.dataclass
class Ranges:
  lin_vel_x: 'tuple[float, float]' = (-1.0, 1.0)
  lin_vel_y: 'tuple[float, float]' = (-1.0, 1.0)
  ang_vel_z: 'tuple[float, float]' = (-1.0, 1.0)
  heading: 'tuple[float, float] | None' = None


@dataclasses.dataclass
class UniformVelocityCommandCfg(CommandTermCfg):
  asset_name: str = 'robot'
  heading_command: bool = False
  heading_control_stiffness: float = 1.0
  rel_standing_envs: float = 0.0
  rel_heading_envs: float = 1.0
  ranges: Ranges = dataclasses.field(default_factory=Ranges)

  def __post_init__(self):
    if self.class_type is None:
      self.class_type = UniformVelocityCommand


class UniformVelocityCommand(CommandTerm):
  """(vx, vy, wz) twist command with optional heading-servo mode, standing
  envs, and velocity-error metrics."""

  @property
  def dim(self):
    return 3

  def init_state(self, gen):
    n = self.num_envs
    z = lambda *shape, dtype=self.dtype: torch.zeros(
        shape, dtype=dtype, device=self.device)
    return {
        'command': z(n, 3),
        'heading_target': z(n),
        'is_heading': z(n, dtype=torch.bool),
        'is_standing': z(n, dtype=torch.bool),
        'time_left': self._time_left(gen),
        'metric/error_vel_xy': z(n),
        'metric/error_vel_yaw': z(n),
    }

  def _resample(self, state, ctx, mask, gen):
    n = self.num_envs
    cfg: UniformVelocityCommandCfg = self.cfg
    r = cfg.ranges
    # the commands_vel curriculum (if present) carries the current
    # x-velocity and yaw-rate ranges in its state
    rx_lo, rx_hi = r.lin_vel_x
    rz_lo, rz_hi = r.ang_vel_z
    curriculum = getattr(ctx.state, 'curriculum', None) or {}
    for cst in curriculum.values():
      if isinstance(cst, dict) and 'range_lin_vel_x' in cst:
        rx_lo, rx_hi = cst['range_lin_vel_x']
      if isinstance(cst, dict) and 'range_ang_vel_z' in cst:
        rz_lo, rz_hi = cst['range_ang_vel_z']
    draw = lambda lo, hi: tmath.sample_uniform(gen, lo, hi, (n,), self.dtype)
    cmd = torch.stack([draw(rx_lo, rx_hi), draw(*r.lin_vel_y),
                       draw(rz_lo, rz_hi)], -1)
    state = dict(state)
    state['command'] = torch.where(mask[:, None], cmd, state['command'])
    if cfg.heading_command and r.heading is not None:
      state['heading_target'] = torch.where(mask, draw(*r.heading),
                                            state['heading_target'])
      ish = draw(0.0, 1.0) < cfg.rel_heading_envs
      state['is_heading'] = torch.where(mask, ish, state['is_heading'])
    iss = draw(0.0, 1.0) < cfg.rel_standing_envs
    state['is_standing'] = torch.where(mask, iss, state['is_standing'])
    return state

  def _update(self, state, ctx):
    cfg: UniformVelocityCommandCfg = self.cfg
    state = dict(state)
    cmd = state['command']
    if cfg.heading_command and cfg.ranges.heading is not None:
      view = ctx.scene[cfg.asset_name]
      heading = view.heading_w(ctx.data)
      err = tmath.wrap_to_pi(state['heading_target'] - heading)
      wz = (cfg.heading_control_stiffness * err).clamp(
          cfg.ranges.ang_vel_z[0], cfg.ranges.ang_vel_z[1])
      cmd = torch.cat(
          [cmd[:, :2], torch.where(state['is_heading'], wz, cmd[:, 2])[:, None]],
          -1)
    cmd = torch.where(state['is_standing'][:, None], torch.zeros_like(cmd),
                      cmd)
    state['command'] = cmd
    return state

  def _update_metrics(self, state, ctx, dt):
    view = ctx.scene[self.cfg.asset_name]
    cmd = state['command']
    v = view.root_lin_vel_b(ctx.data)
    w = view.root_ang_vel_b(ctx.data)
    max_t = ctx.max_episode_length
    state = dict(state)
    state['metric/error_vel_xy'] = state['metric/error_vel_xy'] + \
        torch.linalg.vector_norm(cmd[:, :2] - v[:, :2], dim=-1) / max_t
    state['metric/error_vel_yaw'] = state['metric/error_vel_yaw'] + \
        (cmd[:, 2] - w[:, 2]).abs() / max_t
    return state

  def debug_vis(self, state, env, env_index: int, vis) -> None:
    """Goal (green) and current (blue) velocity arrows above the robot, and
    the commanded yaw rate (yellow), of env `env_index`."""
    data = env.state.data
    view = env.scene[self.cfg.asset_name]
    row = lambda t: t[env_index].cpu().numpy()
    base = row(view.root_pos_w(data))
    quat = row(view.root_quat_w(data))
    cmd = row(state['command'])
    vel_b = row(view.root_lin_vel_b(data))
    # yaw-only rotation of the base-frame xy command into world
    yaw = np.arctan2(2 * (quat[0] * quat[3] + quat[1] * quat[2]),
                     1 - 2 * (quat[2] ** 2 + quat[3] ** 2))
    c, s = np.cos(yaw), np.sin(yaw)

    def to_world(vb):
      return np.asarray([c * vb[0] - s * vb[1], s * vb[0] + c * vb[1], 0.0])

    top = base + np.asarray([0.0, 0.0, 0.6])
    vis.add_arrow(top, top + 0.5 * to_world(cmd),
                  color=(0.2, 0.8, 0.2, 0.9), radius=0.015)
    vis.add_arrow(top, top + 0.5 * to_world(vel_b),
                  color=(0.2, 0.4, 0.9, 0.9), radius=0.015)
    # yaw-rate indicator: a short arrow along +y proportional to wz
    vis.add_arrow(top, top + np.asarray([0.0, 0.25 * float(cmd[2]), 0.0]),
                  color=(0.9, 0.7, 0.1, 0.7), radius=0.01)
