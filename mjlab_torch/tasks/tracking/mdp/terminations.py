"""Tracking-task termination terms.

Counterpart of mjlab_tpu/tasks/tracking/mdp/terminations.py: the robot's
anchor or end effectors too far from the motion's."""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.managers.term_cfg import SceneEntityCfg, take
from mjlab_torch.physics.tables import table
from mjlab_torch.tasks.tracking.mdp.rewards import _subset, _term_state
from mjlab_torch.utils import math as tmath

_GRAVITY = np.array([0.0, 0.0, -1.0])


def bad_anchor_pos(ctx, threshold: float, command_name: str = 'motion'):
  term, st = _term_state(ctx, command_name)
  return torch.linalg.vector_norm(
      term.anchor_pos_w(st, ctx) - term.robot_anchor_pos_w(ctx),
      dim=-1) > threshold


def bad_anchor_pos_z_only(ctx, threshold: float,
                          command_name: str = 'motion'):
  term, st = _term_state(ctx, command_name)
  return (term.anchor_pos_w(st, ctx)[:, 2]
          - term.robot_anchor_pos_w(ctx)[:, 2]).abs() > threshold


def bad_anchor_ori(ctx, threshold: float, command_name: str = 'motion',
                   asset_cfg: SceneEntityCfg = SceneEntityCfg('robot')):
  term, st = _term_state(ctx, command_name)
  g = table(_GRAVITY, ctx.data.qpos.dtype, ctx.data.qpos.device)
  motion_g = tmath.quat_apply_inverse(term.anchor_quat_w(st), g)
  robot_g = tmath.quat_apply_inverse(term.robot_anchor_quat_w(ctx), g)
  return (motion_g[:, 2] - robot_g[:, 2]).abs() > threshold


def bad_motion_body_pos(ctx, threshold: float,
                        command_name: str = 'motion', body_names=None):
  term, st = _term_state(ctx, command_name)
  ids = _subset(term, body_names)
  err = torch.linalg.vector_norm(
      take(st['body_pos_relative_w'], ids)
      - take(term.robot_body_pos_w(ctx), ids), dim=-1)
  return (err > threshold).any(-1)


def bad_motion_body_pos_z_only(ctx, threshold: float,
                               command_name: str = 'motion',
                               body_names=None):
  term, st = _term_state(ctx, command_name)
  ids = _subset(term, body_names)
  err = (take(st['body_pos_relative_w'], ids)[..., 2]
         - take(term.robot_body_pos_w(ctx), ids)[..., 2]).abs()
  return (err > threshold).any(-1)
