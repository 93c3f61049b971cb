"""Manager term configuration dataclasses and SceneEntityCfg.

Counterpart of mjlab_tpu/managers/term_cfg.py (the port keeps its own
copy): terms are plain functions over the environment context plus
declarative params; configs are discovered by type from the task config
dataclasses (utils.dataclasses.get_terms).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Literal, Sequence

import numpy as np

from mjref.physics.tables import ix
from mjref.utils.string import resolve_matching_names


def take(x, ids, dim: int = 1):
  """x restricted along `dim` to a resolved selection: `slice(None)` (all)
  or a static index array, which is uploaded once per device."""
  if isinstance(ids, slice):
    return x
  return x.index_select(dim, ix(ids, x.device))


@dataclasses.dataclass
class SceneEntityCfg:
  """Declarative selection of an entity and its joints, bodies, geoms and
  sites. `resolve(scene)` turns the regexes into static index arrays (or
  `slice(None)` for "all") when the env is built."""
  name: str = 'robot'
  joint_names: 'str | Sequence[str] | None' = None
  body_names: 'str | Sequence[str] | None' = None
  geom_names: 'str | Sequence[str] | None' = None
  site_names: 'str | Sequence[str] | None' = None
  preserve_order: bool = False

  joint_ids: Any = None  # np.ndarray | slice after resolve
  body_ids: Any = None
  geom_ids: Any = None
  site_ids: Any = None

  def resolve(self, scene) -> 'SceneEntityCfg':
    idx = scene[self.name].idx

    def _res(expr, names):
      if expr is None:
        return slice(None)
      ids, _ = resolve_matching_names(expr, names, self.preserve_order)
      if len(ids) == len(names) and not self.preserve_order:
        return slice(None)
      return np.asarray(ids, np.int32)

    self.joint_ids = _res(self.joint_names, idx.joint_names)
    self.body_ids = _res(self.body_names, idx.body_names)
    self.geom_ids = _res(self.geom_names, idx.geom_names)
    self.site_ids = _res(self.site_names, idx.site_names)
    return self


@dataclasses.dataclass
class NoiseModelCfgLike:
  """An empty base of noise model cfgs, kept under the JAX package's
  name for cfg code written against it."""


@dataclasses.dataclass
class ObservationTermCfg:
  func: Callable = None
  params: dict = dataclasses.field(default_factory=dict)
  noise: Any = None  # NoiseCfg | NoiseModelWithAdditiveBiasCfg
  clip: 'tuple[float, float] | None' = None
  scale: Any = None  # float | tuple
  history_length: int = 0
  flatten_history_dim: bool = True


@dataclasses.dataclass
class ObservationGroupCfg:
  concatenate_terms: bool = True
  enable_corruption: bool = False
  history_length: 'int | None' = None
  flatten_history_dim: bool = True


@dataclasses.dataclass
class ActionTermCfg:
  class_type: type = None
  asset_name: str = 'robot'


@dataclasses.dataclass
class RewardTermCfg:
  func: Callable = None
  weight: float = 0.0
  params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TerminationTermCfg:
  func: Callable = None
  time_out: bool = False
  params: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class EventTermCfg:
  func: Callable = None
  mode: Literal['startup', 'reset', 'interval'] = 'reset'
  params: dict = dataclasses.field(default_factory=dict)
  interval_range_s: 'tuple[float, float] | None' = None
  is_global_time: bool = False
  min_step_count_between_reset: int = 0


@dataclasses.dataclass
class CommandTermCfg:
  class_type: type = None
  resampling_time_range: 'tuple[float, float]' = (10.0, 10.0)


@dataclasses.dataclass
class CurriculumTermCfg:
  func: Callable = None
  params: dict = dataclasses.field(default_factory=dict)


def term(cls=None, /, **kwargs):
  """Helper: `x: RewardTermCfg = term(RewardTermCfg, func=..., weight=1.0)`.
  Every cfg instance gets its own copy of the arguments, so editing one
  cfg's params, noise or ranges never reaches another's."""
  if cls is None:
    raise ValueError('term() requires the cfg class as first argument')
  return dataclasses.field(
      default_factory=lambda: cls(**copy.deepcopy(kwargs)))
