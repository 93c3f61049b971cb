"""Functional manager stack: action / observation / reward / termination /
event / curriculum managers.

Counterpart of mjlab_tpu/managers/managers.py: each manager is built once
with the env (resolving regexes, measuring term widths, allocating state
templates) and then exposes pure `compute` / `reset` functions over
(EnvCtx, state dict, torch.Generator). Terms are discovered by scanning the
config dataclass fields by type. Every function works on the full batch
with masks: none reads a tensor's value on the host.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch

from mjlab_torch.managers.term_cfg import (
    ActionTermCfg,
    CurriculumTermCfg,
    EventTermCfg,
    ObservationGroupCfg,
    ObservationTermCfg,
    RewardTermCfg,
    SceneEntityCfg,
    TerminationTermCfg,
)
from mjlab_torch.physics.tables import table
from mjlab_torch.utils import buffers, math as tmath, noise as noise_utils
from mjlab_torch.utils.dataclasses import get_terms


def _resolve_params(params: dict, scene, func=None) -> dict:
  out = {}
  for k, v in params.items():
    if isinstance(v, SceneEntityCfg):
      out[k] = copy.deepcopy(v).resolve(scene)
    else:
      out[k] = v
  if func is not None:
    # resolve SceneEntityCfg defaults not overridden by params (terms use a
    # shared default instance; it must never be resolved in place)
    try:
      sig = inspect.signature(func)
    except (TypeError, ValueError):
      return out
    for pname, p in sig.parameters.items():
      if pname not in out and isinstance(p.default, SceneEntityCfg):
        out[pname] = copy.deepcopy(p.default).resolve(scene)
  return out


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
  """The (N,) mask shaped to broadcast over the rows of x."""
  return mask.reshape((-1,) + (1,) * (x.ndim - 1))


# ---------------------------------------------------------------------------
# Action manager
# ---------------------------------------------------------------------------


class ActionTerm:
  """Base action term: built from cfg + scene; pure process/apply."""

  def __init__(self, cfg: ActionTermCfg, scene, num_envs: int):
    self.cfg = cfg
    self.scene = scene
    self.num_envs = num_envs

  @property
  def action_dim(self) -> int:
    raise NotImplementedError

  def process(self, action: torch.Tensor) -> torch.Tensor:
    return action

  def apply(self, ctx, data, processed: torch.Tensor):
    raise NotImplementedError


class ActionManager:

  def __init__(self, cfg, scene, num_envs: int):
    self.terms: 'dict[str, ActionTerm]' = {}
    for name, tcfg in get_terms(cfg, ActionTermCfg).items():
      self.terms[name] = tcfg.class_type(tcfg, scene, num_envs)
    self.dims = [t.action_dim for t in self.terms.values()]
    self.total_dim = sum(self.dims)

  @property
  def active_terms(self):
    return list(self.terms)

  def process(self, action: torch.Tensor) -> torch.Tensor:
    """Split + per-term process; returns concatenated processed actions."""
    out = []
    ofs = 0
    for t, d in zip(self.terms.values(), self.dims):
      out.append(t.process(action[:, ofs:ofs + d]))
      ofs += d
    return torch.cat(out, dim=-1) if out else action

  def apply(self, ctx, data, processed: torch.Tensor):
    ofs = 0
    for t, d in zip(self.terms.values(), self.dims):
      data = t.apply(ctx, data, processed[:, ofs:ofs + d])
      ofs += d
    return data


# ---------------------------------------------------------------------------
# Observation manager
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ObsTermInfo:
  name: str
  cfg: ObservationTermCfg
  params: dict
  dim: int
  history: int  # effective history length (0 = none)
  flatten: bool
  has_bias_model: bool


class ObservationManager:
  """Groups of observation terms with a noise / clip / scale / history
  pipeline. `probe(func, params)` returns the shape of one term's value:
  the env calls the term once on its template state."""

  def __init__(self, cfg, scene, num_envs: int, probe: Callable):
    self.scene = scene
    self.num_envs = num_envs
    self.groups: 'dict[str, list[_ObsTermInfo]]' = {}
    self.group_cfgs: 'dict[str, ObservationGroupCfg]' = {}
    for gname, gcfg in get_terms(cfg, ObservationGroupCfg).items():
      terms = []
      for tname, tcfg in get_terms(gcfg, ObservationTermCfg).items():
        params = _resolve_params(tcfg.params, scene, tcfg.func)
        shape = probe(tcfg.func, params)
        dim = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        hist = (gcfg.history_length if gcfg.history_length is not None
                else tcfg.history_length)
        flatten = (gcfg.flatten_history_dim if gcfg.history_length is not None
                   else tcfg.flatten_history_dim)
        has_bias = isinstance(tcfg.noise,
                              noise_utils.NoiseModelWithAdditiveBiasCfg)
        terms.append(_ObsTermInfo(tname, tcfg, params, dim, hist or 0,
                                  flatten, has_bias))
      self.groups[gname] = terms
      self.group_cfgs[gname] = gcfg

  def group_dim(self, gname: str) -> int:
    total = 0
    for t in self.groups[gname]:
      d = t.dim
      if t.history:
        d = d * t.history if t.flatten else d
      total += d
    return total

  def init_state(self, dtype, device) -> dict:
    st: dict = {}
    for gname, terms in self.groups.items():
      for t in terms:
        key = f'{gname}/{t.name}'
        if t.history:
          st[f'{key}/hist'] = buffers.create(self.num_envs, t.history, t.dim,
                                             dtype, device)
        if t.has_bias_model:
          st[f'{key}/bias'] = noise_utils.bias_init(
              self.num_envs, t.dim, dtype, device)
    return st

  def reset(self, state: dict, mask: torch.Tensor,
            gen: torch.Generator) -> dict:
    out = dict(state)
    for gname, terms in self.groups.items():
      for t in terms:
        k = f'{gname}/{t.name}'
        if f'{k}/hist' in out:
          out[f'{k}/hist'] = buffers.reset(out[f'{k}/hist'], mask)
        if f'{k}/bias' in out:
          out[f'{k}/bias'] = noise_utils.bias_reset(
              t.cfg.noise, gen, out[f'{k}/bias'], mask)
    return out

  def compute(self, ctx, state: dict,
              gen: torch.Generator) -> 'tuple[dict, dict]':
    obs: dict = {}
    new_state = dict(state)
    for gname, terms in self.groups.items():
      gcfg = self.group_cfgs[gname]
      pieces = []
      for t in terms:
        val = t.cfg.func(ctx, **t.params)
        val = val.reshape(ctx.num_envs, -1)
        if gcfg.enable_corruption and t.cfg.noise is not None:
          if t.has_bias_model:
            val = noise_utils.bias_apply(
                t.cfg.noise, gen, val, new_state[f'{gname}/{t.name}/bias'])
          else:
            val = noise_utils.apply_noise(t.cfg.noise, gen, val)
        if t.cfg.clip is not None:
          val = val.clamp(t.cfg.clip[0], t.cfg.clip[1])
        if t.cfg.scale is not None:
          val = val * table(np.asarray(t.cfg.scale, np.float64), val.dtype,
                            val.device)
        if t.history:
          hk = f'{gname}/{t.name}/hist'
          cb = buffers.append(new_state[hk], val)
          new_state[hk] = cb
          frames = buffers.all_frames(cb)  # (N, H, d) oldest->newest
          val = frames.reshape(ctx.num_envs, -1) if t.flatten else frames
        pieces.append(val)
      if gcfg.concatenate_terms:
        obs[gname] = (torch.cat(pieces, dim=-1) if pieces else torch.zeros(
            (ctx.num_envs, 0), dtype=ctx.data.qpos.dtype,
            device=ctx.data.qpos.device))
      else:
        obs[gname] = {t.name: p for t, p in zip(terms, pieces)}
    return obs, new_state


# ---------------------------------------------------------------------------
# Reward manager
# ---------------------------------------------------------------------------


class RewardManager:
  """Stateless terms are plain functions `f(ctx, **params) -> (N,)`;
  stateful terms (feet_air_time's per-foot clocks) declare
  `func.init_state(num_envs=..., dtype=..., device=..., **params)` and have
  the signature `f(ctx, state, **params) -> (value, new_state)`. Their
  state lives in EnvState.reward and is zeroed where an env resets."""

  def __init__(self, cfg, scene):
    self.terms: 'dict[str, RewardTermCfg]' = {}
    self.params: 'dict[str, dict]' = {}
    for name, tcfg in get_terms(cfg, RewardTermCfg).items():
      self.terms[name] = tcfg
      self.params[name] = _resolve_params(tcfg.params, scene, tcfg.func)

  @property
  def active_terms(self):
    return list(self.terms)

  def init_state(self, num_envs: int, dtype, device) -> dict:
    st = {}
    for name, tcfg in self.terms.items():
      init_fn = getattr(tcfg.func, 'init_state', None)
      # weight-0 terms are skipped entirely, so they carry no state either
      if init_fn is not None and tcfg.weight != 0.0:
        st[name] = init_fn(num_envs=num_envs, dtype=dtype, device=device,
                           **self.params[name])
    return st

  def reset_state(self, state: dict, mask: torch.Tensor) -> dict:
    new = dict(state)
    for name in state:
      reset_fn = getattr(self.terms[name].func, 'reset_state', None)
      if reset_fn is not None:
        new[name] = reset_fn(state[name], mask)
      else:
        new[name] = {k: torch.where(_rows(mask, x), torch.zeros_like(x), x)
                     for k, x in state[name].items()}
    return new

  def compute(self, ctx, episode_sums: torch.Tensor, dt: float,
              state: 'dict | None' = None):
    """Returns (reward (N,), new episode_sums, per-term dict, new state)."""
    n = ctx.num_envs
    zero = torch.zeros(n, dtype=ctx.data.qpos.dtype,
                       device=ctx.data.qpos.device)
    total = zero
    values = {}
    columns = []
    new_state = dict(state or {})
    for name, tcfg in self.terms.items():
      if tcfg.weight == 0.0:
        values[name] = zero
        columns.append(zero)
        continue
      if state is not None and name in state:
        raw, new_state[name] = tcfg.func(ctx, state[name],
                                         **self.params[name])
      else:
        raw = tcfg.func(ctx, **self.params[name])
      v = raw * tcfg.weight * dt
      values[name] = v
      total = total + v
      columns.append(v)
    sums = (episode_sums + torch.stack(columns, dim=-1) if columns
            else episode_sums)
    return total, sums, values, new_state


# ---------------------------------------------------------------------------
# Termination manager
# ---------------------------------------------------------------------------


class TerminationManager:

  def __init__(self, cfg, scene):
    self.terms: 'dict[str, TerminationTermCfg]' = {}
    self.params: 'dict[str, dict]' = {}
    for name, tcfg in get_terms(cfg, TerminationTermCfg).items():
      self.terms[name] = tcfg
      self.params[name] = _resolve_params(tcfg.params, scene, tcfg.func)

  @property
  def active_terms(self):
    return list(self.terms)

  def compute(self, ctx):
    n = ctx.num_envs
    terminated = torch.zeros(n, dtype=torch.bool, device=ctx.data.qpos.device)
    truncated = terminated
    per_term = {}
    for name, tcfg in self.terms.items():
      v = tcfg.func(ctx, **self.params[name]).bool()
      per_term[name] = v
      if tcfg.time_out:
        truncated = truncated | v
      else:
        terminated = terminated | v
    return terminated, truncated, per_term


# ---------------------------------------------------------------------------
# Event manager
# ---------------------------------------------------------------------------


class EventManager:
  """Modes: startup (model/data transform when the env is built), reset
  (masked data transform), interval (per-env or global clocks).

  Data events are `fn(ctx, data, mask, gen, **params) -> Data`; model
  events (tagged `is_model_event = True`) are
  `fn(model, scene, gen, mask, **params) -> Model`."""

  def __init__(self, cfg, scene, num_envs: int, step_dt: float):
    self.scene = scene
    self.num_envs = num_envs
    self.step_dt = step_dt
    self.startup_terms: 'dict[str, tuple[EventTermCfg, dict]]' = {}
    self.reset_terms: 'dict[str, tuple[EventTermCfg, dict]]' = {}
    self.interval_terms: 'dict[str, tuple[EventTermCfg, dict]]' = {}
    for name, tcfg in get_terms(cfg, EventTermCfg).items():
      params = _resolve_params(tcfg.params, scene, tcfg.func)
      if tcfg.mode == 'startup':
        self.startup_terms[name] = (tcfg, params)
      elif tcfg.mode == 'reset':
        self.reset_terms[name] = (tcfg, params)
      elif tcfg.mode == 'interval':
        if tcfg.interval_range_s is None:
          raise ValueError(f'interval event {name} needs interval_range_s')
        self.interval_terms[name] = (tcfg, params)
      else:
        raise ValueError(f'unknown event mode {tcfg.mode}')

  def domain_randomization_fields(self) -> 'list[str]':
    """Model fields touched by model events: they need a per-env axis."""
    fields = []
    for tcfg, params in list(self.startup_terms.values()) + \
        list(self.reset_terms.values()):
      if getattr(tcfg.func, 'is_model_event', False) and 'field' in params:
        fields.append(params['field'])
    return fields

  def _interval(self, tcfg: EventTermCfg, gen: torch.Generator,
                dtype) -> torch.Tensor:
    lo, hi = tcfg.interval_range_s
    shape = () if tcfg.is_global_time else (self.num_envs,)
    return tmath.sample_uniform(gen, lo, hi, shape, dtype)

  def init_state(self, gen: torch.Generator, dtype, device) -> dict:
    st = {}
    for name, (tcfg, _) in self.interval_terms.items():
      st[f'{name}/time_left'] = self._interval(tcfg, gen, dtype)
    for name, (tcfg, _) in self.reset_terms.items():
      if tcfg.min_step_count_between_reset > 0:
        # per-env step of the last trigger; -1 = never triggered
        st[f'{name}/last_trigger'] = torch.full(
            (self.num_envs,), -1, dtype=torch.int32, device=device)
    return st

  def apply_startup(self, model, data, gen: torch.Generator):
    everyone = torch.ones(self.num_envs, dtype=torch.bool,
                          device=data.qpos.device)
    for name, (tcfg, params) in self.startup_terms.items():
      if getattr(tcfg.func, 'is_model_event', False):
        model = tcfg.func(model, self.scene, gen, everyone, **params)
      else:
        data = tcfg.func(None, data, everyone, gen, **params)
    return model, data

  def apply_reset(self, ctx, data, model, state: dict, mask: torch.Tensor,
                  gen: torch.Generator, common_step: torch.Tensor):
    state = dict(state)
    for name, (tcfg, params) in self.reset_terms.items():
      m = mask
      if tcfg.min_step_count_between_reset > 0:
        # fire on the first reset, then only after min_step_count more
        # global steps have elapsed for that env
        last = state[f'{name}/last_trigger']
        ok = (last < 0) | (common_step - last
                           >= tcfg.min_step_count_between_reset)
        m = mask & ok
        state[f'{name}/last_trigger'] = torch.where(
            m, common_step.to(torch.int32), last)
      if getattr(tcfg.func, 'is_model_event', False):
        model = tcfg.func(model, self.scene, gen, m, **params)
      else:
        data = tcfg.func(ctx, data, m, gen, **params)
    return data, model, state

  def apply_interval(self, ctx, data, state: dict, gen: torch.Generator):
    new_state = dict(state)
    for name, (tcfg, params) in self.interval_terms.items():
      tl = state[f'{name}/time_left'] - self.step_dt
      expired = tl <= 0.0
      resampled = self._interval(tcfg, gen, tl.dtype)
      new_state[f'{name}/time_left'] = torch.where(expired, resampled, tl)
      mask = expired.expand(ctx.num_envs) if tcfg.is_global_time else expired
      data = tcfg.func(ctx, data, mask, gen, **params)
    return data, new_state


# ---------------------------------------------------------------------------
# Curriculum manager
# ---------------------------------------------------------------------------


class CurriculumManager:

  def __init__(self, cfg, scene):
    self.scene = scene
    self.terms: 'dict[str, CurriculumTermCfg]' = {}
    self.params: 'dict[str, dict]' = {}
    for name, tcfg in get_terms(cfg, CurriculumTermCfg).items():
      self.terms[name] = tcfg
      self.params[name] = _resolve_params(tcfg.params, scene, tcfg.func)

  def origin_term(self) -> 'str | None':
    """The name of the term (if any) whose state carries the per-env spawn
    origins (the terrain-level curriculum)."""
    for name, tcfg in self.terms.items():
      if getattr(tcfg.func, 'provides_env_origins', False):
        return name
    return None

  @property
  def active_terms(self):
    return list(self.terms)

  def init_state(self) -> dict:
    st = {}
    for name, tcfg in self.terms.items():
      init_fn = getattr(tcfg.func, 'init_state', None)
      if init_fn is not None:
        st[name] = init_fn(scene=self.scene, **self.params[name])
    return st

  def replicated_state(self) -> 'list[str]':
    """'<term>/<key>' paths of the state keys that a term's function names
    in its `replicated_state` attribute: every rank's alike in a sharded
    env (CommandTerm.replicated_state)."""
    return [f'{name}/{k}' for name, tcfg in self.terms.items()
            for k in getattr(tcfg.func, 'replicated_state', ())]

  def compute(self, ctx, state: dict, mask: torch.Tensor):
    """Run curriculum terms on reset envs; returns (new state, metrics)."""
    new_state = dict(state)
    metrics = {}
    for name, tcfg in self.terms.items():
      st = state.get(name)
      res = tcfg.func(ctx, st, mask, **self.params[name])
      if isinstance(res, tuple):
        new_state[name], metric = res
      else:
        new_state[name], metric = st if st is not None else res, res
      if metric is not None:
        metrics[f'Curriculum/{name}'] = metric
    return new_state, metrics
