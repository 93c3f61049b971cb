"""Pluggable metric writers for the training runner.

Counterpart of mjlab_tpu/rl/writers.py, selected by
RslRlOnPolicyRunnerCfg.logger: 'jsonl' (always), 'tensorboard' (event files
through `torch.utils.tensorboard`, which needs the `tensorboard` package:
without it `make_writers('tensorboard', ...)` raises ImportError), 'wandb'
(falls back to tensorboard, or to jsonl alone, with a warning when the
package or the network is unavailable).
"""

from __future__ import annotations

import json
import os
from typing import Protocol


class Writer(Protocol):

  def log(self, metrics: dict, step: int) -> None:
    ...

  def close(self) -> None:
    ...


class JsonlWriter:
  """One JSON object per log call: the machine-readable baseline."""

  def __init__(self, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    self._f = open(os.path.join(log_dir, 'metrics.jsonl'), 'a')

  def log(self, metrics: dict, step: int) -> None:
    self._f.write(json.dumps(metrics) + '\n')
    self._f.flush()

  def close(self) -> None:
    self._f.close()


class TensorboardWriter:
  """Scalar curves, one tag per metric key ('Episode_Reward/track_lin_vel',
  'Metrics/twist/error_vel_xy', ...)."""

  def __init__(self, log_dir: str):
    from torch.utils.tensorboard import SummaryWriter
    self._w = SummaryWriter(log_dir)

  def log(self, metrics: dict, step: int) -> None:
    for k, v in metrics.items():
      if isinstance(v, (int, float)):
        self._w.add_scalar(k, v, step)

  def close(self) -> None:
    self._w.close()


class WandbWriter:

  def __init__(self, log_dir: str, project: str, run_name: str | None = None):
    import wandb
    # offline unless WANDB_MODE says otherwise, so that a host without a
    # network logs locally instead of blocking in wandb.init
    if 'WANDB_MODE' not in os.environ:
      os.environ['WANDB_MODE'] = 'offline'
      print('[writers] WANDB_MODE unset; defaulting to offline '
            '(set WANDB_MODE=online for live upload)')
    self._run = wandb.init(project=project, name=run_name, dir=log_dir)

  def log(self, metrics: dict, step: int) -> None:
    self._run.log(metrics, step=step)

  def close(self) -> None:
    self._run.finish()


def make_writers(logger: str, log_dir: str, project: str = 'mjlab_torch',
                 run_name: str | None = None) -> list:
  """The writer stack for a logger config value; always includes jsonl so
  that downstream tooling has a dependency-free record."""
  writers: list = [JsonlWriter(log_dir)]
  if logger == 'tensorboard':
    writers.append(TensorboardWriter(log_dir))
  elif logger == 'wandb':
    try:
      writers.append(WandbWriter(log_dir, project, run_name))
    except Exception as e:  # package missing or no network
      fallback = 'tensorboard' if _has_tensorboard() else 'jsonl only'
      print(f'[writers] wandb unavailable ({e!r}); falling back to '
            f'{fallback}')
      if _has_tensorboard():
        writers.append(TensorboardWriter(log_dir))
  return writers


def _has_tensorboard() -> bool:
  try:
    import tensorboard  # noqa: F401
    return True
  except ImportError:
    return False
