"""Action terms: joint position PD targets.

Counterpart of mjlab_tpu/envs/mdp/actions.py."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from mjref.managers.managers import ActionTerm
from mjref.managers.term_cfg import ActionTermCfg
from mjref.utils.string import (
    resolve_matching_names,
    resolve_matching_names_values,
)


def _resolve_scalar_or_dict(value, names, default=0.0):
  out = np.full(len(names), default, np.float64)
  if isinstance(value, dict):
    ids, _, vals = resolve_matching_names_values(value, names)
    out[ids] = vals
  else:
    out[:] = value
  return out


class JointAction(ActionTerm):
  """Base: per-joint affine transform action -> target."""

  def __init__(self, cfg, scene, num_envs):
    super().__init__(cfg, scene, num_envs)
    view = scene[cfg.asset_name]
    self.view = view
    ids, names = resolve_matching_names(
        cfg.joint_names, view.idx.joint_names, cfg.preserve_order)
    self.joint_ids = np.asarray(ids, np.int32)
    self.joint_names = names
    offset = _resolve_scalar_or_dict(cfg.offset, names, 0.0)
    if cfg.use_default_offset:
      offset = view.default_joint_pos.cpu().numpy()[self.joint_ids]
    # scale and offset are single-precision constants, as in the reference
    # and in the exported policy's metadata, whatever the Model's dtype
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32)).to(
        device=view.device, dtype=scene.model.dtype)
    self.scale = f32(_resolve_scalar_or_dict(cfg.scale, names, 1.0))
    self.offset = f32(offset)

  @property
  def action_dim(self):
    return len(self.joint_ids)

  def process(self, action):
    return action * self.scale[None, :] + self.offset[None, :]


class JointPositionAction(JointAction):
  """Processed action -> PD position target (ctrl)."""

  def apply(self, ctx, data, processed):
    return self.view.write_joint_position_target(
        data, processed, joint_ids=self.joint_ids)


@dataclasses.dataclass
class JointPositionActionCfg(ActionTermCfg):
  joint_names: Sequence[str] = ('.*',)
  scale: 'float | dict' = 1.0
  offset: 'float | dict' = 0.0
  use_default_offset: bool = True
  preserve_order: bool = False

  def __post_init__(self):
    if self.class_type is None:
      self.class_type = JointPositionAction
