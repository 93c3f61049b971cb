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
         mj_model=None, **cfg_overrides):
  """Build the task's environment on `device` (the GPU unless the caller
  asks for 'cpu'). `mj_model` replaces the compiled scene the cfg names;
  `cfg_overrides` set dotted cfg fields
  (`**{'scene.num_envs': 4096}`)."""
  from mjref.envs.manager_based_rl_env import ManagerBasedRlEnv
  if cfg is None:
    cfg = load_cfg(task_id)
  for k, v in cfg_overrides.items():
    obj = cfg
    parts = k.split('.')
    for p in parts[:-1]:
      obj = getattr(obj, p)
    setattr(obj, parts[-1], v)
  return ManagerBasedRlEnv(cfg, device=device, dtype=dtype,
                           mj_model=mj_model)


def _import_all():
  """Import every task configuration package
  (mjref/tasks/<family>/config/<robot>/) so that its registrations run: a
  task added as new files registers itself."""
  import importlib
  from pathlib import Path

  root = Path(__file__).parent
  for pkg in sorted(root.glob('*/config/*/__init__.py')):
    importlib.import_module('.'.join(
        ('mjref', 'tasks') + pkg.parent.relative_to(root).parts))
