"""Command manager: stateful command generators as pure state machines.

Counterpart of mjlab_tpu/managers/command_manager.py: each term keeps a
per-env countdown clock, resamples on expiry, and exposes a command tensor
plus logging metrics. State is a dict of tensors threaded through the step;
draws come from the env's `torch.Generator`.
"""

from __future__ import annotations

import torch

from mjref.managers.term_cfg import CommandTermCfg
from mjref.utils import math as tmath
from mjref.utils.dataclasses import get_terms


class CommandTerm:
  """Base command term. Subclasses implement _resample/_update/
  _update_metrics; `device` and `dtype` are those of the env's Model."""

  def __init__(self, cfg: CommandTermCfg, scene, num_envs: int):
    self.cfg = cfg
    self.scene = scene
    self.num_envs = num_envs
    self.device = scene.device
    self.dtype = scene.model.dtype

  @property
  def dim(self) -> int:
    raise NotImplementedError

  def init_state(self, gen: torch.Generator) -> dict:
    raise NotImplementedError

  def value(self, state: dict) -> torch.Tensor:
    return state['command']

  def _time_left(self, gen: torch.Generator) -> torch.Tensor:
    lo, hi = self.cfg.resampling_time_range
    return tmath.sample_uniform(gen, lo, hi, (self.num_envs,), self.dtype)

  def reset(self, state: dict, ctx, mask: torch.Tensor,
            gen: torch.Generator) -> dict:
    state = dict(state)
    state['time_left'] = torch.where(mask, self._time_left(gen),
                                     state['time_left'])
    state = self._resample(state, ctx, mask, gen)
    # zero metrics on reset
    for k in list(state):
      if k.startswith('metric/'):
        state[k] = torch.where(mask, torch.zeros_like(state[k]), state[k])
    return state

  def compute(self, state: dict, ctx, gen: torch.Generator,
              dt: float) -> dict:
    state = self._update_metrics(dict(state), ctx, dt)
    tl = state['time_left'] - dt
    expired = tl <= 0.0
    state['time_left'] = torch.where(expired, self._time_left(gen), tl)
    state = self._resample(state, ctx, expired, gen)
    return self._update(state, ctx)

  def metrics(self, state: dict) -> dict:
    return {k[len('metric/'):]: v for k, v in state.items()
            if k.startswith('metric/')}

  # subclass hooks
  def _resample(self, state, ctx, mask, gen):
    return state

  def _update(self, state, ctx):
    return state

  def _update_metrics(self, state, ctx, dt):
    return state

  def debug_vis(self, state: dict, env, env_index: int, vis) -> None:
    """Viewer hook: draw env `env_index`'s command into `vis` (a
    viewer.debug_visualizer.DebugVisualizer). It runs on the host, reads
    only that env's rows, and only a viewer calls it, never a step. The
    base term draws nothing."""


class CommandManager:

  def __init__(self, cfg, scene, num_envs: int):
    self.terms: 'dict[str, CommandTerm]' = {}
    for name, tcfg in get_terms(cfg, CommandTermCfg).items():
      self.terms[name] = tcfg.class_type(tcfg, scene, num_envs)

  @property
  def active_terms(self):
    return list(self.terms)

  def init_state(self, gen: torch.Generator) -> dict:
    return {name: term.init_state(gen) for name, term in self.terms.items()}

  def values(self, state: dict) -> dict:
    return {name: term.value(state[name])
            for name, term in self.terms.items()}

  def reset(self, state: dict, ctx, mask: torch.Tensor,
            gen: torch.Generator):
    new = {}
    metrics = {}
    for name, term in self.terms.items():
      # collect metrics of resetting envs before zeroing
      for mk, mv in term.metrics(state[name]).items():
        metrics[f'Metrics/{name}/{mk}'] = mv
      new[name] = term.reset(state[name], ctx, mask, gen)
    return new, metrics

  def compute(self, state: dict, ctx, gen: torch.Generator,
              dt: float) -> dict:
    return {name: term.compute(state[name], ctx, gen, dt)
            for name, term in self.terms.items()}
