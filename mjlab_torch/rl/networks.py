"""The actor network and its observation normalizer, for inference.

Counterpart of the inference half of mjlab_tpu/rl/networks.py and of the
inference policy of mjlab_tpu/rl/ppo.py: `MLP`, the actor of `ActorCritic`
(`act_mean`) and `RunningNorm.normalize`, as `nn.Module`s. The linear layers
are plain matrix products (`nn.Linear`), as in the reference.

`actor_from_numpy` carries weights across from a flax parameter tree;
`save_actor` / `load_actor` keep them in an .npz file that needs neither
flax nor orbax to read.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

_ACT = {'elu': nn.ELU, 'relu': nn.ReLU, 'tanh': nn.Tanh, 'gelu': nn.GELU,
        'silu': nn.SiLU}


class MLP(nn.Module):
  """Dense layers with an activation after each hidden layer;
  `layers[i]` is the reference's `Dense_i`."""

  def __init__(self, in_dim: int, hidden_dims: Sequence[int], out_dim: int,
               activation: str = 'elu'):
    super().__init__()
    dims = [in_dim, *hidden_dims, out_dim]
    self.layers = nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
    self.act = _ACT[activation]()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for layer in self.layers[:-1]:
      x = self.act(layer(x))
    return self.layers[-1](x)


class RunningNorm(nn.Module):
  """Empirical observation normalization with fixed statistics."""

  def __init__(self, dim: int):
    super().__init__()
    self.register_buffer('mean', torch.zeros(dim))
    self.register_buffer('var', torch.ones(dim))

  def normalize(self, x: torch.Tensor) -> torch.Tensor:
    # epsilon on std (not var): near-constant dims must not explode
    return (x - self.mean) / (torch.sqrt(self.var) + 1e-2)


class Actor(nn.Module):
  """The policy's actor: observation groups concatenated, normalized if the
  policy was trained with actor normalization, then the MLP's mean action."""

  def __init__(self, obs_dim: int, action_dim: int,
               hidden_dims: Sequence[int] = (512, 256, 128),
               activation: str = 'elu', normalize_obs: bool = False,
               obs_groups: Sequence[str] = ('policy',)):
    super().__init__()
    self.actor = MLP(obs_dim, hidden_dims, action_dim, activation)
    self.norm = RunningNorm(obs_dim)
    self.normalize_obs = normalize_obs
    self.obs_groups = tuple(obs_groups)

  def act_mean(self, actor_obs: torch.Tensor) -> torch.Tensor:
    return self.actor(actor_obs)

  @torch.no_grad()
  def forward(self, obs) -> torch.Tensor:
    """The inference policy: an env's observation dict (or the actor's
    observation tensor) -> mean action."""
    if isinstance(obs, dict):
      obs = torch.cat([obs[g] for g in self.obs_groups], dim=-1)
    if self.normalize_obs:
      obs = self.norm.normalize(obs)
    return self.act_mean(obs)


def actor_from_numpy(params: dict, norm: 'dict | None' = None,
                     normalize_obs: bool = False, activation: str = 'elu',
                     device='cuda', dtype=torch.float32) -> Actor:
  """Actor from a flax parameter tree as numpy:
  params['params']['actor']['Dense_i']['kernel' | 'bias'], kernel (in, out)
  (`nn.Linear.weight` is its transpose), and the normalizer's
  {'mean', 'var'}."""
  from mjlab_torch.physics.io import resolve_device
  tree = params['params']['actor']
  dense = [tree[f'Dense_{i}'] for i in range(len(tree))]
  kernels = [np.asarray(d['kernel']) for d in dense]
  actor = Actor(kernels[0].shape[0], kernels[-1].shape[1],
                [k.shape[1] for k in kernels[:-1]], activation,
                normalize_obs)
  with torch.no_grad():
    for layer, d, k in zip(actor.actor.layers, dense, kernels):
      layer.weight.copy_(torch.tensor(k.T))
      layer.bias.copy_(torch.tensor(np.asarray(d['bias'])))
    if norm is not None:
      actor.norm.mean.copy_(torch.tensor(np.asarray(norm['mean'])))
      actor.norm.var.copy_(torch.tensor(np.asarray(norm['var'])))
  actor.requires_grad_(False)  # inference only
  return actor.to(device=resolve_device(device), dtype=dtype).eval()


def save_actor(path, params: dict, norm: dict, normalize_obs: bool,
               activation: str = 'elu') -> None:
  """Write the actor's layers and the normalizer to an .npz file."""
  tree = params['params']['actor']
  arrays = {'normalize_obs': np.asarray(normalize_obs),
            'activation': np.asarray(activation),
            'norm_mean': np.asarray(norm['mean'], np.float32),
            'norm_var': np.asarray(norm['var'], np.float32)}
  for i in range(len(tree)):
    arrays[f'actor_{i}_kernel'] = np.asarray(tree[f'Dense_{i}']['kernel'],
                                             np.float32)
    arrays[f'actor_{i}_bias'] = np.asarray(tree[f'Dense_{i}']['bias'],
                                           np.float32)
  np.savez_compressed(path, **arrays)


def actor_arrays(path) -> 'tuple[dict, dict, bool, str]':
  """(params, norm, normalize_obs, activation) of an .npz written by
  `save_actor`, in the layout `actor_from_numpy` takes."""
  with np.load(path, allow_pickle=False) as z:
    n = sum(k.endswith('_kernel') for k in z.files)
    tree = {f'Dense_{i}': {'kernel': z[f'actor_{i}_kernel'],
                           'bias': z[f'actor_{i}_bias']} for i in range(n)}
    return ({'params': {'actor': tree}},
            {'mean': z['norm_mean'], 'var': z['norm_var']},
            bool(z['normalize_obs']), str(z['activation']))


def load_actor(path, device='cuda', dtype=torch.float32) -> Actor:
  """The actor of an .npz written by `save_actor`, on `device`."""
  params, norm, normalize_obs, activation = actor_arrays(path)
  return actor_from_numpy(params, norm, normalize_obs, activation,
                          device=device, dtype=dtype)
