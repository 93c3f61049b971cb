"""Tracking-task reward terms.

Counterpart of mjlab_tpu/tasks/tracking/mdp/rewards.py: exponentials of
the motion's tracking errors, and the self-collision count."""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.managers.term_cfg import SceneEntityCfg, take
from mjlab_torch.utils import math as tmath

_DEFAULT = SceneEntityCfg('robot')


def _term_state(ctx, command_name):
  return ctx.command_terms[command_name], ctx.state.command[command_name]


def _subset(term, body_names):
  """The tracked bodies among `body_names` (indices into the command's
  body list), or all of them."""
  if body_names is None:
    return slice(None)
  return np.asarray(
      [i for i, n in enumerate(term.cfg.body_names) if n in body_names],
      np.int32)


def motion_global_anchor_position_error_exp(ctx, std: float,
                                            command_name: str = 'motion'):
  term, st = _term_state(ctx, command_name)
  err = (term.anchor_pos_w(st, ctx) - term.robot_anchor_pos_w(ctx)).square(
  ).sum(-1)
  return torch.exp(-err / std ** 2)


def motion_global_anchor_orientation_error_exp(ctx, std: float,
                                               command_name: str = 'motion'):
  term, st = _term_state(ctx, command_name)
  err = tmath.quat_error_magnitude(
      term.anchor_quat_w(st), term.robot_anchor_quat_w(ctx)) ** 2
  return torch.exp(-err / std ** 2)


def motion_relative_body_position_error_exp(
    ctx, std: float, command_name: str = 'motion', body_names=None):
  term, st = _term_state(ctx, command_name)
  ids = _subset(term, body_names)
  err = (take(st['body_pos_relative_w'], ids)
         - take(term.robot_body_pos_w(ctx), ids)).square().sum(-1)
  return torch.exp(-err.mean(-1) / std ** 2)


def motion_relative_body_orientation_error_exp(
    ctx, std: float, command_name: str = 'motion', body_names=None):
  term, st = _term_state(ctx, command_name)
  ids = _subset(term, body_names)
  err = tmath.quat_error_magnitude(
      take(st['body_quat_relative_w'], ids),
      take(term.robot_body_quat_w(ctx), ids)) ** 2
  return torch.exp(-err.mean(-1) / std ** 2)


def motion_global_body_linear_velocity_error_exp(
    ctx, std: float, command_name: str = 'motion', body_names=None):
  term, st = _term_state(ctx, command_name)
  ids = _subset(term, body_names)
  err = (take(term.body_lin_vel_w(st), ids)
         - take(term.robot_body_lin_vel_w(ctx), ids)).square().sum(-1)
  return torch.exp(-err.mean(-1) / std ** 2)


def motion_global_body_angular_velocity_error_exp(
    ctx, std: float, command_name: str = 'motion', body_names=None):
  term, st = _term_state(ctx, command_name)
  ids = _subset(term, body_names)
  err = (take(term.body_ang_vel_w(st), ids)
         - take(term.robot_body_ang_vel_w(ctx), ids)).square().sum(-1)
  return torch.exp(-err.mean(-1) / std ** 2)


def self_collision_cost(ctx, sensor_name: str,
                        asset_cfg: SceneEntityCfg = _DEFAULT):
  """The number of self-collisions a contact sensor with data='found' and
  reduce='netforce' counts."""
  view = ctx.scene[asset_cfg.name]
  return view.sensor_data(ctx.data, sensor_name)[:, 0]
