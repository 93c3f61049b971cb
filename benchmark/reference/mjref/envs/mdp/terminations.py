"""Termination terms. Counterpart of mjlab_tpu/envs/mdp/terminations.py."""

from __future__ import annotations

import torch

from mjref.managers.term_cfg import SceneEntityCfg

_DEFAULT = SceneEntityCfg('robot')


def time_out(ctx):
  # the step counter is int32: an episode length beyond its range (a play
  # configuration's "never") must not wrap
  return ctx.episode_length >= min(ctx.max_episode_length, 2 ** 31 - 1)


def bad_orientation(ctx, limit_angle: float,
                    asset_cfg: SceneEntityCfg = _DEFAULT):
  g = ctx.scene[asset_cfg.name].projected_gravity_b(ctx.data)
  angle = torch.acos((-g[:, 2]).clamp(-1.0, 1.0))
  return angle > limit_angle


def root_height_below_minimum(ctx, minimum_height: float,
                              asset_cfg: SceneEntityCfg = _DEFAULT):
  return ctx.scene[asset_cfg.name].root_pos_w(ctx.data)[:, 2] < minimum_height
