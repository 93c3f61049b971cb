"""Tracking-task observation terms.

Counterpart of mjlab_tpu/tasks/tracking/mdp/observations.py: the motion's
anchor and the robot's tracked bodies in the robot anchor's frame."""

from __future__ import annotations

from mjlab_torch.utils import math as tmath


def _term_state(ctx, command_name):
  return ctx.command_terms[command_name], ctx.state.command[command_name]


def _two_columns(quat):
  """The first two columns of each rotation, flattened per env."""
  mat = tmath.matrix_from_quat(quat)
  return mat[..., :2].reshape(quat.shape[0], -1)


def _motion_anchor_b(ctx, command_name):
  term, st = _term_state(ctx, command_name)
  return tmath.subtract_frame_transforms(
      term.robot_anchor_pos_w(ctx), term.robot_anchor_quat_w(ctx),
      term.anchor_pos_w(st, ctx), term.anchor_quat_w(st))


def motion_anchor_pos_b(ctx, command_name: str = 'motion'):
  return _motion_anchor_b(ctx, command_name)[0].reshape(ctx.num_envs, -1)


def motion_anchor_ori_b(ctx, command_name: str = 'motion'):
  return _two_columns(_motion_anchor_b(ctx, command_name)[1])


def _robot_bodies_b(ctx, command_name):
  term = ctx.command_terms[command_name]
  return tmath.subtract_frame_transforms(
      term.robot_anchor_pos_w(ctx)[:, None, :],
      term.robot_anchor_quat_w(ctx)[:, None, :],
      term.robot_body_pos_w(ctx), term.robot_body_quat_w(ctx))


def robot_body_pos_b(ctx, command_name: str = 'motion'):
  return _robot_bodies_b(ctx, command_name)[0].reshape(ctx.num_envs, -1)


def robot_body_ori_b(ctx, command_name: str = 'motion'):
  return _two_columns(_robot_bodies_b(ctx, command_name)[1])
