"""Velocity-task reward terms.

Counterpart of mjlab_tpu/tasks/velocity/mdp/rewards.py."""

from __future__ import annotations

import torch

from mjref.managers.term_cfg import SceneEntityCfg

_DEFAULT = SceneEntityCfg('robot')


def track_lin_vel_exp(ctx, std: float, command_name: str = 'base_velocity',
                      asset_cfg: SceneEntityCfg = _DEFAULT):
  view = ctx.scene[asset_cfg.name]
  cmd = ctx.commands[command_name]
  v = view.root_lin_vel_b(ctx.data)
  err = (cmd[:, :2] - v[:, :2]).square().sum(-1)
  return torch.exp(-err / std ** 2)


def track_ang_vel_exp(ctx, std: float, command_name: str = 'base_velocity',
                      asset_cfg: SceneEntityCfg = _DEFAULT):
  view = ctx.scene[asset_cfg.name]
  cmd = ctx.commands[command_name]
  w = view.root_ang_vel_b(ctx.data)
  err = (cmd[:, 2] - w[:, 2]).square()
  return torch.exp(-err / std ** 2)


def _foot_contacts(view, data, sensor_names) -> torch.Tensor:
  """(N, F) bool: each foot's found-flag contact sensor."""
  return torch.stack(
      [view.sensor_data(data, s)[:, 0] > 0.5 for s in sensor_names], -1)


def feet_slide(ctx, sensor_names: tuple, asset_cfg: SceneEntityCfg,
               threshold: float = 1.0):
  """Penalize foot sliding while in contact; contact state comes from
  per-foot found-flag contact sensors."""
  view = ctx.scene[asset_cfg.name]
  contacts = _foot_contacts(view, ctx.data, sensor_names)
  body_vel = view.body_lin_vel_w(ctx.data, asset_cfg.body_ids)  # (N, F, 3)
  speed = torch.linalg.vector_norm(body_vel[..., :2], dim=-1)
  return (speed * contacts.to(speed.dtype)).sum(-1)


def foot_clearance_reward(ctx, asset_cfg: SceneEntityCfg,
                          target_height: float, std: float,
                          tanh_mult: float = 2.0):
  """Reward swing-foot clearance."""
  view = ctx.scene[asset_cfg.name]
  pos = view.body_pos_w(ctx.data, asset_cfg.body_ids)
  vel = view.body_lin_vel_w(ctx.data, asset_cfg.body_ids)
  z_err = (pos[..., 2] - target_height).square()
  vel_tanh = torch.tanh(
      tanh_mult * torch.linalg.vector_norm(vel[..., :2], dim=-1))
  return torch.exp(-(z_err * vel_tanh).sum(-1) / std)


def feet_air_time(ctx, state, sensor_names: tuple = (),
                  asset_name: str = 'robot',
                  command_name: str = 'twist',
                  threshold_min: float = 0.05,
                  threshold_max: float = 0.15,
                  command_threshold: float = 0.05,
                  reward_mode: str = 'continuous',
                  command_scale_type: str = 'smooth',
                  command_scale_width: float = 0.2):
  """Reward long steps (stateful: per-foot air and contact clocks threaded
  through the reward manager's state).

  continuous: 1.0 per foot while in air with threshold_min < air_time <=
  threshold_max. on_landing: clamp(last_air_time - threshold_min) / dt on
  first contact. Scaled by a smooth (tanh) or hard command-magnitude
  gate."""
  view = ctx.scene[asset_name]
  in_contact = _foot_contacts(view, ctx.data, sensor_names)
  in_air = ~in_contact

  air = state['current_air_time']
  contact_t = state['current_contact_time']
  last_air = state['last_air_time']
  zero = torch.zeros_like(air)

  first_contact = (air > 0) & in_contact
  last_air = torch.where(first_contact, air, last_air)
  air = torch.where(in_contact, zero, air + ctx.step_dt)
  contact_t = torch.where(in_contact, contact_t + ctx.step_dt, zero)

  if reward_mode == 'continuous':
    per_foot = (in_air & (air > threshold_min) &
                (air <= threshold_max)).to(air.dtype)
    reward = per_foot.sum(-1)
  else:  # on_landing
    over = (last_air - threshold_min).clamp(0.0,
                                            threshold_max - threshold_min)
    reward = (over * first_contact).sum(-1) / ctx.step_dt

  cmd_norm = torch.linalg.vector_norm(ctx.commands[command_name][:, :2],
                                      dim=-1)
  if command_scale_type == 'smooth':
    scale = 0.5 * (1.0 + torch.tanh(
        (cmd_norm - command_threshold) / command_scale_width))
  else:
    scale = (cmd_norm > command_threshold).to(reward.dtype)
  new_state = {'current_air_time': air, 'current_contact_time': contact_t,
               'last_air_time': last_air}
  return reward * scale, new_state


def _feet_air_time_init(num_envs: int = 1, dtype=torch.float32, device='cpu',
                        sensor_names: tuple = (), **kw):
  del kw
  z = torch.zeros((num_envs, max(len(sensor_names), 1)), dtype=dtype,
                  device=device)
  return {'current_air_time': z, 'current_contact_time': z,
          'last_air_time': z}


feet_air_time.init_state = _feet_air_time_init
