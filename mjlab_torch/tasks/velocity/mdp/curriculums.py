"""Velocity-task curriculum terms.

Counterpart of mjlab_tpu/tasks/velocity/mdp/curriculums.py, without the
terrain-level curriculum (rough terrain only)."""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.physics.tables import table


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
