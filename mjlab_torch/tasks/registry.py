"""Lightweight task registry.

Counterpart of mjlab_tpu/tasks/registry.py. Tasks register an env-cfg
factory under an `Mjlab-*` id; `make()` builds the environment. Factories
(not instances) are stored so each make() gets a fresh config to mutate.
"""

from __future__ import annotations

import copy
from typing import Any, Callable

import torch

_REGISTRY: 'dict[str, dict[str, Any]]' = {}


def register(task_id: str, env_cfg_entry_point: Callable, **extra) -> None:
  if task_id in _REGISTRY:
    raise ValueError(f'task {task_id!r} already registered')
  _REGISTRY[task_id] = dict(env_cfg_entry_point=env_cfg_entry_point, **extra)


def registered_tasks() -> 'list[str]':
  _import_all()
  return sorted(_REGISTRY)


def load_cfg(task_id: str, kind: str = 'env_cfg_entry_point'):
  _import_all()
  if task_id not in _REGISTRY:
    raise KeyError(
        f'unknown task {task_id!r}; available: {sorted(_REGISTRY)}')
  factory = _REGISTRY[task_id].get(kind)
  if factory is None:
    raise KeyError(f'task {task_id!r} has no {kind}')
  return factory() if callable(factory) else copy.deepcopy(factory)


def make(task_id: str, cfg=None, device='cuda', dtype=torch.float32,
         mj_model=None, world=None, **cfg_overrides):
  """Build the task's environment on `device` (the GPU unless the caller
  asks for 'cpu'). `mj_model` replaces the compiled scene the cfg names;
  `world` makes it one rank's part of a sharded env
  (parallel/sharding.py); `cfg_overrides` set dotted cfg fields
  (`**{'scene.num_envs': 4096}`)."""
  from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnv
  if cfg is None:
    cfg = load_cfg(task_id)
  for k, v in cfg_overrides.items():
    obj = cfg
    parts = k.split('.')
    for p in parts[:-1]:
      obj = getattr(obj, p)
    setattr(obj, parts[-1], v)
  return ManagerBasedRlEnv(cfg, device=device, dtype=dtype,
                           mj_model=mj_model, world=world)


def _import_all():
  """Import all task packages so their registrations run, then the task
  modules that `MJLAB_TASKS_MODULES` names (comma-separated importable
  module paths whose import registers tasks: user tasks, and the Tiny
  debug tasks, mjlab_torch.tasks.velocity.config.tiny and
  mjlab_torch.tasks.tracking.config.tiny, which are not imported here)."""
  import importlib
  import os

  import mjlab_torch.tasks.velocity.config.g1  # noqa: F401
  import mjlab_torch.tasks.velocity.config.go1  # noqa: F401
  import mjlab_torch.tasks.tracking.config.g1  # noqa: F401
  for mod in filter(None, os.environ.get('MJLAB_TASKS_MODULES',
                                         '').split(',')):
    importlib.import_module(mod.strip())
