"""Event terms: resets, pushes, external wrenches, and domain randomization
of model fields.

Counterpart of mjlab_tpu/envs/mdp/events.py. Data events have the signature
`fn(ctx, data, mask, gen, **params) -> Data` and apply masked updates over
the full batch. Model events (domain randomization of model fields) have
`fn(model, scene, gen, mask, **params) -> Model`, are tagged
`is_model_event = True`, and need their field to carry a leading env axis
(the env expands it when it is built). Draws come from the explicit
`torch.Generator`; a range collapsed to a point gives exactly that point.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Literal, Optional, Tuple, Union

import numpy as np
import torch

from mjref.managers.term_cfg import SceneEntityCfg
from mjref.physics.tables import ix
from mjref.utils import math as tmath

_DEFAULT = SceneEntityCfg('robot')
_AXES = ('x', 'y', 'z', 'roll', 'pitch', 'yaw')


def _sample_range(gen, rng: 'tuple[float, float] | None', shape, dtype):
  if rng is None:
    return torch.zeros(shape, dtype=dtype, device=gen.device)
  return tmath.sample_uniform(gen, rng[0], rng[1], shape, dtype)


def _sample_axes(gen, ranges: dict, n: int, dtype) -> torch.Tensor:
  """(n, 6): one uniform draw per env for each of x, y, z, roll, pitch, yaw
  that `ranges` names, zero for the others."""
  return torch.stack(
      [_sample_range(gen, ranges.get(k), (n,), dtype) for k in _AXES], -1)


def _default_root_state(ctx, view) -> torch.Tensor:
  """(N, 13) default root state placed at each env's origin."""
  root = view.default_root_state.expand(ctx.num_envs, -1).clone()
  root[:, :3] += ctx.env_origins
  return root


# ---------------------------------------------------------------------------
# Reset events
# ---------------------------------------------------------------------------


def reset_scene_to_default(ctx, data, mask, gen):
  """Reset every entity to its default (init_state) at its env origin."""
  del gen
  for name in ctx.scene.entities:
    view = ctx.scene[name]
    if not view.is_fixed_base:
      data = view.write_root_state(data, _default_root_state(ctx, view), mask)
    if view.is_articulated:
      pos = view.default_joint_pos.expand(ctx.num_envs, -1)
      vel = view.default_joint_vel.expand(ctx.num_envs, -1)
      data = view.write_joint_state(data, pos, vel, mask=mask)
  return data


def reset_root_state_uniform(
    ctx, data, mask, gen,
    pose_range: Dict[str, Tuple[float, float]],
    velocity_range: Dict[str, Tuple[float, float]],
    asset_cfg: SceneEntityCfg = _DEFAULT):
  """Default root state plus uniform pose and velocity offsets."""
  view = ctx.scene[asset_cfg.name]
  n = ctx.num_envs
  dtype = data.qpos.dtype
  base = _default_root_state(ctx, view)
  dpose = _sample_axes(gen, pose_range, n, dtype)
  pos = base[:, :3] + dpose[:, :3]
  dq = tmath.quat_from_euler_xyz(dpose[:, 3], dpose[:, 4], dpose[:, 5])
  quat = tmath.quat_mul(base[:, 3:7], dq)
  vel = base[:, 7:13] + _sample_axes(gen, velocity_range, n, dtype)
  return view.write_root_state(data, torch.cat([pos, quat, vel], -1), mask)


def reset_joints_by_scale(
    ctx, data, mask, gen,
    position_range: Tuple[float, float],
    velocity_range: Tuple[float, float],
    asset_cfg: SceneEntityCfg = _DEFAULT):
  """Default joint state scaled by uniform factors, clamped to the soft
  limits."""
  view = ctx.scene[asset_cfg.name]
  n = ctx.num_envs
  dtype = data.qpos.dtype
  nj = len(view.idx.joint_names)
  pos = view.default_joint_pos[None] * tmath.sample_uniform(
      gen, position_range[0], position_range[1], (n, nj), dtype)
  vel = view.default_joint_vel[None] * tmath.sample_uniform(
      gen, velocity_range[0], velocity_range[1], (n, nj), dtype)
  lim = view.soft_joint_pos_limits
  pos = torch.minimum(torch.maximum(pos, lim[:, 0]), lim[:, 1])
  return view.write_joint_state(data, pos, vel, mask=mask)


# ---------------------------------------------------------------------------
# Interval events
# ---------------------------------------------------------------------------


def push_by_setting_velocity(
    ctx, data, mask, gen,
    velocity_range: Dict[str, Tuple[float, float]],
    asset_cfg: SceneEntityCfg = _DEFAULT):
  """Add a random velocity impulse to the root."""
  view = ctx.scene[asset_cfg.name]
  dv = _sample_axes(gen, velocity_range, ctx.num_envs, data.qpos.dtype)
  vel = data.qvel[:, ix(view.idx.free_v_adr, data.qvel.device)] + dv
  return view.write_root_velocity(data, vel, mask)


def apply_external_force_torque(
    ctx, data, mask, gen,
    force_range: Tuple[float, float],
    torque_range: Tuple[float, float],
    asset_cfg: SceneEntityCfg = _DEFAULT):
  """A random wrench on the selected bodies: (n, nb, 3) force and torque,
  each uniform over its range, written into `xfrc_applied` of the masked
  envs. It acts in every substep until the next draw, or until the env's
  reset clears it."""
  view = ctx.scene[asset_cfg.name]
  nb = len(view.idx.body_ids[asset_cfg.body_ids])
  shape = (ctx.num_envs, nb, 3)
  dtype = data.qpos.dtype
  force = tmath.sample_uniform(gen, *force_range, shape, dtype)
  torque = tmath.sample_uniform(gen, *torque_range, shape, dtype)
  return view.write_external_wrench(data, force, torque,
                                    body_ids=asset_cfg.body_ids, mask=mask)


# ---------------------------------------------------------------------------
# Domain randomization over model fields
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FieldSpec:
  entity_type: Literal['dof', 'joint', 'body', 'geom', 'site']
  use_address: bool = False
  default_axes: Optional[tuple] = None


FIELD_SPECS = {
    'dof_armature': FieldSpec('dof', use_address=True),
    'dof_frictionloss': FieldSpec('dof', use_address=True),
    'dof_damping': FieldSpec('dof', use_address=True),
    'jnt_range': FieldSpec('joint'),
    'jnt_stiffness': FieldSpec('joint'),
    'body_mass': FieldSpec('body'),
    'body_ipos': FieldSpec('body', default_axes=(0, 1, 2)),
    'body_iquat': FieldSpec('body', default_axes=(0, 1, 2, 3)),
    'body_inertia': FieldSpec('body'),
    'body_pos': FieldSpec('body', default_axes=(0, 1, 2)),
    'body_quat': FieldSpec('body', default_axes=(0, 1, 2, 3)),
    'geom_friction': FieldSpec('geom', default_axes=(0,)),
    'geom_pos': FieldSpec('geom', default_axes=(0, 1, 2)),
    'geom_quat': FieldSpec('geom', default_axes=(0, 1, 2, 3)),
    'geom_rgba': FieldSpec('geom', default_axes=(0, 1, 2, 3)),
    'site_pos': FieldSpec('site', default_axes=(0, 1, 2)),
    'site_quat': FieldSpec('site', default_axes=(0, 1, 2, 3)),
    'qpos0': FieldSpec('joint', use_address=True),
}


def _entity_indices(view, asset_cfg: SceneEntityCfg, spec: FieldSpec):
  idx = view.idx
  base, sel = {
      'dof': (idx.v_adr, asset_cfg.joint_ids),
      'joint': (idx.q_adr if spec.use_address else idx.jnt_ids,
                asset_cfg.joint_ids),
      'body': (idx.body_ids, asset_cfg.body_ids),
      'geom': (idx.geom_ids, asset_cfg.geom_ids),
      'site': (idx.site_ids, asset_cfg.site_ids),
  }[spec.entity_type]
  return base[sel]


def _draw(gen, distribution: str, lo, hi, shape, dtype) -> torch.Tensor:
  if distribution == 'uniform':
    return tmath.sample_uniform(gen, lo, hi, shape, dtype)
  if distribution == 'log_uniform':
    return tmath.sample_log_uniform(gen, lo, hi, shape, dtype)
  if distribution == 'gaussian':
    return tmath.sample_gaussian(gen, lo, hi, shape, dtype)
  raise ValueError(distribution)


def randomize_field(
    model, scene, gen, mask,
    field: str,
    ranges: Union[Tuple[float, float], Dict[int, Tuple[float, float]]],
    distribution: Literal['uniform', 'log_uniform', 'gaussian'] = 'uniform',
    operation: Literal['add', 'scale', 'abs'] = 'abs',
    asset_cfg: SceneEntityCfg = _DEFAULT,
    axes: Optional[List[int]] = None):
  """Unified model-field randomization; writes the masked rows only, with
  `scale` and `add` acting on the current value.

  The model field must carry a leading env axis (the env expands it when
  it is built); the engine reads every field of FIELD_SPECS per env.
  Returns a new Model: the old one and its tensors are left as they were."""
  if field not in FIELD_SPECS:
    raise ValueError(f'unknown field {field!r}; supported: '
                     f'{list(FIELD_SPECS)}')
  spec = FIELD_SPECS[field]
  view = scene[asset_cfg.name]
  ids = ix(np.asarray(_entity_indices(view, asset_cfg, spec)), model.device)

  arr = getattr(model, field)  # (N, n_entity_total, [naxes])
  if arr.ndim < 2 or arr.shape[0] != mask.shape[0]:
    raise ValueError(
        f'model field {field} is not env-expanded; got shape {arr.shape}')
  sub = arr[:, ids]  # (N, k) or (N, k, naxes)
  scalar_field = sub.ndim == 2
  if scalar_field:
    target_axes = (0,)
    new = sub[..., None].clone()
  else:
    target_axes = tuple(axes) if axes is not None else (
        spec.default_axes if spec.default_axes is not None
        else tuple(range(sub.shape[-1])))
    new = sub.clone()

  for ax in target_axes:
    if isinstance(ranges, dict):
      if ax not in ranges:
        continue
      lo, hi = ranges[ax]
    else:
      lo, hi = ranges
    vals = _draw(gen, distribution, lo, hi, new.shape[:-1], arr.dtype)
    if operation == 'abs':
      new[..., ax] = vals
    elif operation == 'add':
      new[..., ax] = new[..., ax] + vals
    elif operation == 'scale':
      new[..., ax] = new[..., ax] * vals
    else:
      raise ValueError(operation)

  if scalar_field:
    new = new[..., 0]
  updated = arr.clone()
  updated[:, ids] = torch.where(
      mask.reshape((-1,) + (1,) * (new.ndim - 1)), new, sub)
  return model.replace(**{field: updated})


randomize_field.is_model_event = True
