"""Velocity-task curriculum terms: the staged command-velocity ranges and
the terrain-level curriculum of the rough tasks.

Counterpart of mjlab_tpu/tasks/velocity/mdp/curriculums.py. Both run on the
whole batch with masks; neither reads a tensor's value on the host."""

from __future__ import annotations

import numpy as np
import torch

from mjref.physics.tables import table


def commands_vel(ctx, state, mask, command_name: str = 'twist',
                 velocity_stages: list = (),
                 base_range: tuple = (-1.0, 1.0)):
  """Staged widening of the commanded x-velocity and yaw-rate ranges by
  global step. The current range is curriculum state that
  UniformVelocityCommand reads when it resamples.

  State: {'range_lin_vel_x': (2,), 'range_ang_vel_z': (2,)}, float32.
  Metric: the current range's magnitude."""
  del mask, state
  step = ctx.state.common_step
  rng = _range(base_range, step.device)
  for s in velocity_stages:
    rng = torch.where(step >= s['step'], _range(s['range'], step.device), rng)
  return ({'range_lin_vel_x': rng, 'range_ang_vel_z': rng}, rng.abs().max())


def _range(r, device) -> torch.Tensor:
  return table(np.asarray(r, np.float64), torch.float32, device)


def _commands_vel_init(scene=None, base_range=(-1.0, 1.0), **kw):
  del kw
  rng = _range(base_range, scene.device)
  return {'range_lin_vel_x': rng, 'range_ang_vel_z': rng}


commands_vel.init_state = _commands_vel_init


def draw_levels(ctx, num_envs: int, max_level: int) -> torch.Tensor:
  """A level in [0, max_level) for every env, from the env's generator:
  where the terrain-level curriculum sends an env promoted past the top."""
  gen = ctx.generator
  return torch.randint(0, max_level, (num_envs,), generator=gen,
                       device=ctx.env_origins.device)


def terrain_levels_vel(ctx, state, mask, command_name: str = 'twist',
                       asset_cfg=None):
  """Walked-distance terrain-level promotion and demotion of the envs that
  reset.

  State: {'levels': (N,) int, 'origins': (N, 3)}. An env that walked
  farther than half a terrain cell from its origin this episode moves up a
  level; one that covered less than half its commanded distance moves
  down. An env promoted past the top level goes to a level drawn with the
  env's generator (`draw_levels`). 'origins' is what the env's context
  gives as `env_origins` while this term is active, so the reset events
  spawn the envs at their new levels. Metric: the mean level."""
  if state is None:  # plane terrain: nothing to promote over
    return None, torch.zeros((), device=ctx.env_origins.device)
  view = ctx.scene[asset_cfg.name if asset_cfg else 'robot']
  terrain = ctx.scene.terrain
  dev, dtype = ctx.data.qpos.device, ctx.data.qpos.dtype
  levels = state['levels']
  origins_table = table(terrain.origins_table, dtype, dev)
  types = table(terrain.terrain_types, torch.long, dev)
  max_level = terrain.max_level

  dist = torch.linalg.vector_norm(
      view.root_pos_w(ctx.data)[:, :2] - state['origins'][:, :2], dim=-1)
  cmd = ctx.commands[command_name]
  required = torch.linalg.vector_norm(cmd[:, :2], dim=-1) * \
      ctx.max_episode_length_s
  cell_half = 0.5 * float(terrain.generator.cfg.size[0])
  move_up = dist > cell_half
  move_down = (dist < required * 0.5) & ~move_up
  new = levels + move_up.to(levels.dtype) - move_down.to(levels.dtype)
  rand_lvl = draw_levels(ctx, levels.shape[0], max_level).to(levels.dtype)
  new = torch.where(new >= max_level, rand_lvl, new.clamp_min(0))
  new = torch.where(mask, new, levels)
  origins = origins_table[new.long(), types]
  return {'levels': new, 'origins': origins}, new.to(torch.float32).mean()


def _terrain_levels_init(scene=None, **kw):
  del kw
  terrain = scene.terrain if scene is not None else None
  if terrain is None or terrain.origins_table is None:
    return None
  levels = table(terrain.terrain_levels, torch.int32, scene.device)
  types = table(terrain.terrain_types, torch.long, scene.device)
  # float32 whatever the env's dtype, as in the JAX package
  origins = table(terrain.origins_table, torch.float32,
                  scene.device)[levels.long(), types]
  return {'levels': levels, 'origins': origins}


terrain_levels_vel.init_state = _terrain_levels_init
terrain_levels_vel.provides_env_origins = True
