"""Copies of the program's state trees: dataclasses, dicts, lists and
tensors, moved whole to another device, or rebuilt as the reference's own
classes (the frozen copy `mjref` has a class of the same module path and
name for every state class of the port)."""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch


def host(t: torch.Tensor) -> torch.Tensor:
  """A copy of `t` in host memory (never the tensor itself, which a CPU
  tensor's `.cpu()` would be)."""
  return t.detach().to('cpu', copy=True)


def move(x, device, clone: bool = True):
  """`x` with every tensor copied to `device` (None: where it is; a new
  tensor even on the same device when `clone`); the tree's own classes are
  kept."""
  if isinstance(x, torch.Tensor):
    if device is None:
      return x.detach().clone() if clone else x.detach()
    return x.detach().to(device, copy=clone)
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    vals = {f.name: move(getattr(x, f.name), device, clone)
            for f in dataclasses.fields(x)}
    return dataclasses.replace(x, **vals) if _replaceable(x) else x
  if isinstance(x, dict):
    return {k: move(v, device, clone) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return type(x)(move(v, device, clone) for v in x)
  return x


def _replaceable(x) -> bool:
  """Dataclasses whose fields all take part in __init__ (the state's own;
  a frozen static table is kept as it is)."""
  return all(f.init for f in dataclasses.fields(x)) and not getattr(
      type(x), '__dataclass_params__').frozen


def rebuild(x, package: str = 'mjref', device=None):
  """`x` rebuilt from the classes of `package` (same module path and name
  as the port's, 'mjlab_torch' replaced by `package`), its tensors moved to
  `device` (kept where they are when None). Frozen static tables are kept
  as they are: they hold numpy arrays and numbers only."""
  if isinstance(x, torch.Tensor):
    return x if device is None else x.to(device)
  if dataclasses.is_dataclass(x) and not isinstance(x, type):
    if not _replaceable(x):
      return x
    mod = type(x).__module__
    if mod.split('.')[0] == 'mjlab_torch':
      mod = package + mod[len('mjlab_torch'):]
    cls = getattr(importlib.import_module(mod), type(x).__qualname__)
    return cls(**{f.name: rebuild(getattr(x, f.name), package, device)
                  for f in dataclasses.fields(x)})
  if isinstance(x, dict):
    return {k: rebuild(v, package, device) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return type(x)(rebuild(v, package, device) for v in x)
  return x


@contextlib.contextmanager
def contacts_recorded(pipeline, into: list):
  """While the block runs, each physics step of `pipeline` (the port's or
  the reference's physics/pipeline.py) appends its active contact slots,
  (num_envs, ncon) bool on the device, to `into`."""
  orig = pipeline.step

  def step(m, d):
    out = orig(m, d)
    c = out.contact
    into.append(c.dist < c.includemargin)
    return out

  pipeline.step = step
  try:
    yield into
  finally:
    pipeline.step = orig

