"""The port's spans and counters, recorded by any torch.profiler session.

`span(name)` is `torch.profiler.record_function(name)` while a profiler
records on this thread, and otherwise one shared no-op context manager
(`OFF`): no dispatcher call, no allocation, no kernel. A span is a host
range on the profiler's timeline, beside the device operations it launches,
so that a kernel can be put down to the span it was launched from, and an
idle stretch of the device to the span the host was in.

`count(name, tensor)` keeps a reference to a tensor the port has already
computed, while a profiler records, and does nothing otherwise; it never
launches a kernel or reads the device. `counters()` sums what was kept, with
one wait for the device, and `reset_counters()` forgets it. What is kept is
not freed until then, so a reader of the counters resets them.

Spans:
  env.step, and env.<stage> for each stage of `ManagerBasedRlEnv._step_fn`
    (action, substeps, guard, terminations, rewards, reset, refresh,
    commands, events, observations) under its default stage hook;
  physics.step, and in every `pipeline.forward` (in each substep and in the
    env's refresh) physics.kinematics, .collision, .dynamics, .constraint,
    .solve, .sensor; physics.integrate in each `pipeline.step`;
  ppo.collection, ppo.learning (a learn iteration's stages), ppo.act (the
    policy's action at each env-step of the rollout), ppo.gae, ppo.update.
Counters:
  contacts_active: each env's active contacts, at each collision call;
  resets: the number of envs reset, at each masked reset (each env-step).
"""

from __future__ import annotations

import torch


class _Off:
  """The span of no profiler: enters and leaves, doing nothing."""

  __slots__ = ()

  def __enter__(self):
    return None

  def __exit__(self, *exc):
    return False


OFF = _Off()

_kept: 'dict[str, list[torch.Tensor]]' = {}


def recording() -> bool:
  """Whether a profiler session records on this thread."""
  return torch._C._autograd._profiler_enabled()


def span(name: str):
  """A profiler range named `name` while a profiler records, else `OFF`."""
  if not recording():
    return OFF
  return torch.profiler.record_function(name)


def stages(prefix: str):
  """A stage hook, `hook(name)` being `span(prefix + name)`; the name is
  joined only while a profiler records."""

  def stage(name: str):
    return span(prefix + name) if recording() else OFF

  return stage


def count(name: str, tensor: torch.Tensor) -> None:
  """Keep `tensor` under `name` while a profiler records."""
  if recording():
    _kept.setdefault(name, []).append(tensor)


def counters() -> 'dict[str, tuple[float, int, int]]':
  """{name: (sum of every element kept, elements, calls of `count`)}."""
  if not _kept:
    return {}
  sums = [torch.cat([t.reshape(-1) for t in kept]).sum(dtype=torch.float64)
          for kept in _kept.values()]
  vals = torch.stack([s.to(sums[0].device) for s in sums]).tolist()
  return {name: (v, sum(t.numel() for t in kept), len(kept))
          for (name, kept), v in zip(_kept.items(), vals)}


def reset_counters() -> None:
  _kept.clear()
