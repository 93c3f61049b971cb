"""Regex-based name resolution (build time, pure Python).

Counterpart of mjlab_tpu/utils/string.py (the port keeps its own copy):
given regex queries and an ordered list of names, resolve the matching
indices deterministically. Used wherever config regexes (joint, body, geom
selections) are turned into static index arrays when the env is built.
"""

from __future__ import annotations

import re
from typing import Sequence


def resolve_matching_names(
    keys: str | Sequence[str],
    names: Sequence[str],
    preserve_order: bool = False,
) -> tuple[list[int], list[str]]:
  """Match regex key(s) against names; return (indices, matched names).

  Default ordering follows `names` order; with preserve_order=True it
  follows the order of `keys` instead. Raises if a key matches nothing or
  two keys match the same name.
  """
  if isinstance(keys, str):
    keys = [keys]
  compiled = [re.compile(k) for k in keys]
  index_list: list[int] = []
  names_list: list[str] = []
  key_of: dict[int, int] = {}
  keys_hit = [False] * len(keys)
  for i, name in enumerate(names):
    for ki, pat in enumerate(compiled):
      if pat.fullmatch(name):
        if i in key_of:
          raise ValueError(
              f"name '{name}' matched by multiple keys: "
              f"'{keys[key_of[i]]}' and '{keys[ki]}'")
        key_of[i] = ki
        keys_hit[ki] = True
        index_list.append(i)
        names_list.append(name)
  if not all(keys_hit):
    missed = [k for k, hit in zip(keys, keys_hit) if not hit]
    raise ValueError(f'keys not found in names: {missed}. Available: {list(names)}')
  if preserve_order:
    order = sorted(range(len(index_list)), key=lambda j: key_of[index_list[j]])
    index_list = [index_list[j] for j in order]
    names_list = [names_list[j] for j in order]
  return index_list, names_list


def resolve_matching_names_values(
    data: dict[str, float],
    names: Sequence[str],
) -> tuple[list[int], list[str], list]:
  """Match a dict of regex -> value onto names.

  Returns (indices, matched names, values), ordered by `names`.
  """
  index_list: list[int] = []
  names_list: list[str] = []
  values_list: list = []
  keys = list(data.keys())
  compiled = [re.compile(k) for k in keys]
  keys_hit = [False] * len(keys)
  for i, name in enumerate(names):
    matched = None
    for ki, pat in enumerate(compiled):
      if pat.fullmatch(name):
        if matched is not None:
          raise ValueError(
              f"name '{name}' matched by multiple keys: "
              f"'{keys[matched]}' and '{keys[ki]}'")
        matched = ki
    if matched is not None:
      keys_hit[matched] = True
      index_list.append(i)
      names_list.append(name)
      values_list.append(data[keys[matched]])
  if not all(keys_hit):
    missed = [k for k, hit in zip(keys, keys_hit) if not hit]
    raise ValueError(f'keys not found in names: {missed}. Available: {list(names)}')
  return index_list, names_list, values_list


def resolve_expr(expr: str | Sequence[str], names: Sequence[str]) -> list[str]:
  """Expand regex expression(s) to the list of matching names (name order)."""
  _, matched = resolve_matching_names(expr, names)
  return matched


def filter_exp(exprs: Sequence[str], names: Sequence[str]) -> list[str]:
  """Prefix-match filter: names matched by any expression, in name order.

  The spec editors' rule: `re.match` (anchored at the start only), unlike
  resolve_matching_names, which wants a full match. So '.*_collision' also
  selects 'FR_thigh_collision1'."""
  compiled = [re.compile(e) for e in exprs]
  return [n for n in names if any(p.match(n) for p in compiled)]


def resolve_prefix_value(field, name: str, default=None):
  """A scalar field, or the value of a {regex: value} field for one name:
  prefix match, the first matching pattern wins."""
  if isinstance(field, dict):
    for pat, val in field.items():
      if re.match(pat, name):
        return val
    return default
  return field
