"""Config-dataclass helpers.

Counterpart of mjlab_tpu/utils/dataclasses.py (the port keeps its own
copy). The manager stack discovers its terms by scanning config dataclass
fields by type, so the config is the schema.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Type, TypeVar

T = TypeVar('T')


def get_terms(cfg: Any, term_type: Type[T]) -> dict[str, T]:
  """Return {name: value} for dataclass fields of the given type, plus
  any extra instance attributes of that type (terms may be injected onto
  a config instance after construction, e.g. `cfg.events.base_mass =
  EventTermCfg(...)`)."""
  if cfg is None:
    return {}
  out = {}
  # fields in declaration order: it is the layout of the concatenated
  # observation vector, so it must not depend on hashing
  field_names = [f.name for f in dataclasses.fields(cfg)]
  for name in field_names:
    value = getattr(cfg, name)
    if isinstance(value, term_type):
      out[name] = value
  declared = set(field_names)
  for name, value in vars(cfg).items():
    if name not in declared and isinstance(value, term_type):
      out[name] = value
  return out


def term(cfg, **overrides):
  """Field helper: `x: RewTerm = term(RewTerm, weight=1.0)` or
  `x: RewTerm = term(instance)` — deep-copied default factory."""
  if isinstance(cfg, type):
    return dataclasses.field(default_factory=lambda: cfg(**overrides))
  if overrides:
    raise ValueError('overrides only valid with a class argument')
  return dataclasses.field(default_factory=lambda: copy.deepcopy(cfg))
