"""Noise configurations and functional noise models.

Counterpart of mjlab_tpu/utils/noise.py: configs are dataclasses, applying
one is a pure function of (cfg, generator, x), and the model with an
additive per-episode bias is (init, reset, apply) over a bias tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from mjref.utils import math as tmath


@dataclasses.dataclass
class NoiseCfg:
  operation: Literal['add', 'scale', 'abs'] = 'add'


@dataclasses.dataclass
class ConstantNoiseCfg(NoiseCfg):
  bias: float = 0.0


@dataclasses.dataclass
class UniformNoiseCfg(NoiseCfg):
  n_min: float = -1.0
  n_max: float = 1.0


@dataclasses.dataclass
class GaussianNoiseCfg(NoiseCfg):
  mean: float = 0.0
  std: float = 1.0


def apply_noise(cfg: 'NoiseCfg | None', gen: torch.Generator,
                x: torch.Tensor) -> torch.Tensor:
  if cfg is None:
    return x
  if isinstance(cfg, ConstantNoiseCfg):
    n = torch.full((), cfg.bias, dtype=x.dtype, device=x.device)
  elif isinstance(cfg, UniformNoiseCfg):
    n = tmath.sample_uniform(gen, cfg.n_min, cfg.n_max, x.shape, x.dtype)
  elif isinstance(cfg, GaussianNoiseCfg):
    n = tmath.sample_gaussian(gen, cfg.mean, cfg.std, x.shape, x.dtype)
  else:
    raise TypeError(f'unknown noise cfg {type(cfg)}')
  if cfg.operation == 'add':
    return x + n
  if cfg.operation == 'scale':
    return x * n
  if cfg.operation == 'abs':
    return n.expand_as(x).clone()
  raise ValueError(cfg.operation)


@dataclasses.dataclass
class NoiseModelCfg:
  noise_cfg: 'NoiseCfg | None' = None


@dataclasses.dataclass
class NoiseModelWithAdditiveBiasCfg(NoiseModelCfg):
  """Per-env additive bias, constant over an episode, drawn anew on
  reset."""
  bias_noise_cfg: 'NoiseCfg | None' = None


def bias_init(num_envs: int, dim: int, dtype=torch.float32,
              device='cpu') -> torch.Tensor:
  return torch.zeros((num_envs, dim), dtype=dtype, device=device)


def bias_reset(cfg: NoiseModelWithAdditiveBiasCfg, gen: torch.Generator,
               bias: torch.Tensor, reset_mask: torch.Tensor) -> torch.Tensor:
  """Draw the bias rows anew where reset_mask is True."""
  new_bias = apply_noise(cfg.bias_noise_cfg, gen, torch.zeros_like(bias))
  return torch.where(reset_mask[:, None], new_bias, bias)


def bias_apply(cfg: NoiseModelWithAdditiveBiasCfg, gen: torch.Generator,
               x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
  return apply_noise(cfg.noise_cfg, gen, x) + bias
