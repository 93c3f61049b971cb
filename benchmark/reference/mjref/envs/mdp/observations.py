"""Observation terms. Counterpart of mjlab_tpu/envs/mdp/observations.py."""

from __future__ import annotations

from mjref.managers.term_cfg import SceneEntityCfg, take

_DEFAULT = SceneEntityCfg('robot')


def base_lin_vel(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  return ctx.scene[asset_cfg.name].root_lin_vel_b(ctx.data)


def base_ang_vel(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  return ctx.scene[asset_cfg.name].root_ang_vel_b(ctx.data)


def projected_gravity(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  return ctx.scene[asset_cfg.name].projected_gravity_b(ctx.data)


def root_pos_w(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  return ctx.scene[asset_cfg.name].root_pos_w(ctx.data)


def root_quat_w(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  return ctx.scene[asset_cfg.name].root_quat_w(ctx.data)


def joint_pos_rel(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  view = ctx.scene[asset_cfg.name]
  ids = asset_cfg.joint_ids
  return take(view.joint_pos(ctx.data), ids) - take(
      view.default_joint_pos, ids, 0)


def joint_vel_rel(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  view = ctx.scene[asset_cfg.name]
  ids = asset_cfg.joint_ids
  return take(view.joint_vel(ctx.data), ids) - take(
      view.default_joint_vel, ids, 0)


def joint_pos(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  return take(ctx.scene[asset_cfg.name].joint_pos(ctx.data),
              asset_cfg.joint_ids)


def joint_vel(ctx, asset_cfg: SceneEntityCfg = _DEFAULT):
  return take(ctx.scene[asset_cfg.name].joint_vel(ctx.data),
              asset_cfg.joint_ids)


def last_action(ctx):
  return ctx.actions


def generated_commands(ctx, command_name: str):
  return ctx.commands[command_name]
