"""Base reward terms. Counterpart of mjlab_tpu/envs/mdp/rewards.py."""

from __future__ import annotations

import numpy as np
import torch

from mjref.managers.term_cfg import SceneEntityCfg, take
from mjref.physics.tables import ix, table
from mjref.utils.string import resolve_matching_names_values

_DEFAULT = SceneEntityCfg('robot')


def is_alive(ctx):
  return (~ctx.terminated).to(ctx.data.qpos.dtype)


def is_terminated(ctx):
  return ctx.terminated.to(ctx.data.qpos.dtype)


def joint_torques_l2(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  view = ctx.scene[asset_cfg.name]
  return view.actuator_force(ctx.data).square().sum(-1)


def joint_acc_l2(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  view = ctx.scene[asset_cfg.name]
  return take(view.joint_acc(ctx.data), asset_cfg.joint_ids).square().sum(-1)


def joint_vel_l2(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  view = ctx.scene[asset_cfg.name]
  return take(view.joint_vel(ctx.data), asset_cfg.joint_ids).square().sum(-1)


def action_rate_l2(ctx):
  return (ctx.actions - ctx.prev_actions).square().sum(-1)


def action_l2(ctx):
  return ctx.actions.square().sum(-1)


def joint_pos_limits(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  """Soft joint limit violation penalty."""
  view = ctx.scene[asset_cfg.name]
  ids = asset_cfg.joint_ids
  q = take(view.joint_pos(ctx.data), ids)
  lim = take(view.soft_joint_pos_limits, ids, 0)
  lower = -(q - lim[:, 0]).clamp_max(0.0)
  upper = (q - lim[:, 1]).clamp_min(0.0)
  return (lower + upper).sum(-1)


def flat_orientation_l2(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  g = ctx.scene[asset_cfg.name].projected_gravity_b(ctx.data)
  return g[:, :2].square().sum(-1)


def electrical_power_cost(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  """|tau . qdot| electrical power proxy."""
  view = ctx.scene[asset_cfg.name]
  tau = view.actuator_force(ctx.data)
  # actuator velocities = joint velocities for scalar joint transmissions
  vel = ctx.data.actuator_velocity[:, ix(view.idx.ctrl_ids, tau.device)]
  return (tau * vel).clamp_min(0.0).sum(-1)


def posture(ctx, std: dict, asset_cfg: SceneEntityCfg = _DEFAULT):
  """Exp-kernel posture reward with per-joint stds resolved by regex."""
  view = ctx.scene[asset_cfg.name]
  ids, _, stds = resolve_matching_names_values(std, view.idx.joint_names)
  ids = np.asarray(ids, np.int32)
  q = view.joint_pos(ctx.data)
  stds = table(np.asarray(stds, np.float64), q.dtype, q.device)
  err = ((take(q, ids) - take(view.default_joint_pos, ids, 0)) / stds).square()
  return torch.exp(-err.mean(-1))


def upright(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  g = ctx.scene[asset_cfg.name].projected_gravity_b(ctx.data)
  return 0.5 * (1.0 - g[:, 2])
