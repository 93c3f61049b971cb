"""Nested-dataclass overrides on the command line
(`--env.scene.num_envs 4096`, `--agent.algorithm.learning_rate=3e-4`).

The port's own copy of mjlab_tpu/utils/cli.py, with the routing of
`--env.*` / `--agent.*` flags that the training and play scripts share.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any


def apply_overrides(obj: Any, overrides: 'list[str]') -> Any:
  """Apply ['--a.b.c', 'value', ...] style overrides in place."""
  i = 0
  while i < len(overrides):
    tok = overrides[i]
    if not tok.startswith('--'):
      raise ValueError(f'expected --flag, got {tok!r}')
    if '=' in tok:
      key, raw = tok[2:].split('=', 1)
      i += 1
    else:
      key = tok[2:]
      if i + 1 >= len(overrides):
        raise ValueError(f'missing value for {tok}')
      raw = overrides[i + 1]
      i += 2
    key = key.replace('-', '_')
    parts = key.split('.')
    target = obj
    for p in parts[:-1]:
      target = getattr(target, p)
    leaf = parts[-1]
    cur = getattr(target, leaf, None)
    setattr(target, leaf, _coerce(raw, cur))
  return obj


def route_overrides(overrides: 'list[str]') -> 'tuple[list, list]':
  """Split `--env.*` and `--agent.*` flags (each with its value, or as
  `--flag=value`) into the env cfg's and the agent cfg's overrides, their
  prefixes cut. Any other flag is an error."""
  env_over, agent_over = [], []
  i = 0
  while i < len(overrides):
    tok = overrides[i]
    take = 1 if '=' in tok else 2
    group = overrides[i:i + take]
    if tok.startswith('--env.'):
      group[0] = '--' + tok[len('--env.'):]
      env_over += group
    elif tok.startswith('--agent.'):
      group[0] = '--' + tok[len('--agent.'):]
      agent_over += group
    else:
      raise SystemExit(f'unknown flag {tok}; use --env.* or --agent.*')
    i += take
  return env_over, agent_over


def _coerce(raw: str, current: Any) -> Any:
  if isinstance(current, bool):
    return raw.lower() in ('1', 'true', 'yes')
  if isinstance(current, int) and not isinstance(current, bool):
    return int(raw)
  if isinstance(current, float):
    return float(raw)
  try:
    return ast.literal_eval(raw)
  except (ValueError, SyntaxError):
    return raw


def print_cfg(cfg: Any, prefix: str = '') -> None:
  """Print every leaf of a (nested) dataclass cfg, one `path = value` line
  each."""
  if dataclasses.is_dataclass(cfg):
    for f in dataclasses.fields(cfg):
      print_cfg(getattr(cfg, f.name), f'{prefix}{f.name}.')
  else:
    print(f'  {prefix[:-1]} = {cfg!r}')


def cfg_to_dict(cfg):
  """A (nested) dataclass cfg as plain dicts and lists, for JSON."""
  if dataclasses.is_dataclass(cfg):
    return {f.name: cfg_to_dict(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}
  if isinstance(cfg, dict):
    return {k: cfg_to_dict(v) for k, v in cfg.items()}
  if isinstance(cfg, (list, tuple)):
    return [cfg_to_dict(v) for v in cfg]
  return cfg
