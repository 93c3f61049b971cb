"""Environment state and context types.

Counterpart of mjlab_tpu/envs/types.py. `EnvState` holds everything that
changes from step to step: the batched physics Data, the Model (with its
per-env fields), and every manager's state. The env's functions take a
state and return a new one; no tensor of the state they were given is
written in place, so a state kept by the caller (the pre-step snapshot, the
template) stays what it was. Random draws come from the env's one
`torch.Generator`, which is not part of the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mjref.physics.types import Data, Model

# the VecEnv conventions: observations are a dict of groups, a step returns
# a tuple
VecEnvObs = dict
VecEnvStepReturn = tuple


@dataclasses.dataclass
class EnvState:
  model: Model
  data: Data  # batched (num_envs, ...)
  episode_length: torch.Tensor  # (N,) int32
  common_step: torch.Tensor  # () int32
  actions: torch.Tensor  # (N, A)
  prev_actions: torch.Tensor
  command: dict  # per command-term state dicts
  obs: dict  # per-term history buffers / noise-bias states
  event: dict  # per-term interval clocks / reset bookkeeping
  reward_sums: torch.Tensor  # (N, n_reward_terms) episode sums
  curriculum: dict
  # stateful reward-term state (per-foot clocks etc.); {} when none
  reward: dict = dataclasses.field(default_factory=dict)
  # the program's physics-blowup forensic ring, carried so that its state
  # rebuilds here; empty in the reference
  forensic: dict = dataclasses.field(default_factory=dict)

  def replace(self, **kwargs) -> 'EnvState':
    return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class EnvCtx:
  """Context handed to every term function, rebuilt from the current
  EnvState wherever the step needs one."""
  model: Model
  data: Data
  scene: Any  # Scene (with its entity views)
  state: EnvState
  actions: torch.Tensor
  prev_actions: torch.Tensor
  commands: dict  # term name -> command value tensor
  command_terms: dict  # term name -> CommandTerm instance (static)
  episode_length: torch.Tensor
  step_dt: float
  physics_dt: float
  max_episode_length: int
  num_envs: int
  env_origins: torch.Tensor
  terminated: Any = None  # set by the env before reward computation
  # the env's one torch.Generator, for terms that draw outside a manager's
  # own generator argument (the terrain-level curriculum)
  generator: 'torch.Generator | None' = None

  @property
  def max_episode_length_s(self) -> float:
    return self.max_episode_length * self.step_dt
