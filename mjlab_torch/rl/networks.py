"""Actor-critic networks and empirical observation normalization.

Counterpart of mjlab_tpu/rl/networks.py: `MLP`, `ActorCritic` (actor, critic
and the learnable noise std), `gaussian_logprob`, `gaussian_entropy` and
`RunningNorm` as `nn.Module`s, plus `Actor`, the actor half alone for
inference. The linear layers are plain matrix products (`nn.Linear`), as in
the reference. A fresh network starts from flax's default initialisation
(`MLP.init_flax_`), the distribution the JAX learner starts from.

Parameters cross over from a flax tree: `actor_critic_from_numpy` and
`actor_from_numpy` take `params['params'][...]['Dense_i']['kernel' |
'bias']` (a kernel is (in, out), `nn.Linear.weight` its transpose) and
`flax_to_named` maps any tree of that layout (parameters, Adam moments) to
the names of `ActorCritic.named_parameters()`.
`save_actor` / `load_actor` keep an actor in an .npz file that needs
neither flax nor orbax to read.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

# flax's gelu is jax.nn.gelu, whose default is the tanh approximation
_ACT = {'elu': nn.ELU, 'relu': nn.ReLU, 'tanh': nn.Tanh,
        'gelu': functools.partial(nn.GELU, approximate='tanh'),
        'silu': nn.SiLU}
# stddev of a unit normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = .87962566103423978
_LOG_2PI = math.log(2 * math.pi)


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

  @torch.no_grad()
  def init_flax_(self, generator: 'torch.Generator | None' = None) -> None:
    """flax's default `nn.Dense` initialisation: a `lecun_normal` kernel
    (a normal truncated at two standard deviations, scaled so that its
    std is sqrt(1 / fan_in)) and a zero bias."""
    for layer in self.layers:
      std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
      nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std,
                            generator=generator)
      nn.init.zeros_(layer.bias)


class ActorCritic(nn.Module):
  """Actor MLP (mean action), critic MLP (value) and the action noise std:
  `std_param` is the std itself ('scalar', clamped at 1e-4) or its log
  ('log'). `generator` draws the flax-style initialisation."""

  def __init__(self, actor_dim: int, critic_dim: int, action_dim: int,
               actor_hidden_dims: Sequence[int] = (512, 256, 128),
               critic_hidden_dims: Sequence[int] = (512, 256, 128),
               activation: str = 'elu', init_noise_std: float = 1.0,
               noise_std_type: str = 'scalar', device='cpu',
               generator: 'torch.Generator | None' = None):
    super().__init__()
    if noise_std_type not in ('scalar', 'log'):
      raise ValueError(f'noise_std_type {noise_std_type!r}')
    self.noise_std_type = noise_std_type
    self.actor = MLP(actor_dim, actor_hidden_dims, action_dim, activation)
    self.critic = MLP(critic_dim, critic_hidden_dims, 1, activation)
    init = (init_noise_std if noise_std_type == 'scalar'
            else math.log(init_noise_std))
    self.std_param = nn.Parameter(torch.full((action_dim,), init))
    self.to(device)
    self.actor.init_flax_(generator)
    self.critic.init_flax_(generator)

  def forward(self, actor_obs, critic_obs):
    return self.act_mean(actor_obs), self.std(), self.value(critic_obs)

  def std(self) -> torch.Tensor:
    if self.noise_std_type == 'scalar':
      return self.std_param.clamp_min(1e-4)
    return torch.exp(self.std_param)

  def act_mean(self, actor_obs: torch.Tensor) -> torch.Tensor:
    return self.actor(actor_obs)

  def value(self, critic_obs: torch.Tensor) -> torch.Tensor:
    return self.critic(critic_obs)[..., 0]


def gaussian_logprob(mean, std, action):
  var = std * std
  return -0.5 * torch.sum(torch.square(action - mean) / var
                          + 2 * torch.log(std) + _LOG_2PI, dim=-1)


def gaussian_entropy(std):
  return torch.sum(0.5 * (1.0 + _LOG_2PI) + torch.log(std), dim=-1)


class RunningNorm(nn.Module):
  """Empirical observation normalization (rsl_rl EmpiricalNormalization
  analog): running mean, population variance and sample count."""

  def __init__(self, dim: int):
    super().__init__()
    self.register_buffer('mean', torch.zeros(dim))
    self.register_buffer('var', torch.ones(dim))
    self.register_buffer('count', torch.tensor(1e-4))

  @classmethod
  def create(cls, dim: int, device='cpu') -> 'RunningNorm':
    return cls(dim).to(device)

  @torch.no_grad()
  def update(self, batch: torch.Tensor) -> None:
    """Fold `batch` (..., dim), flattened over its leading axes, into the
    statistics, in place. The batch variance is the population one
    (ddof 0), as jnp.var's."""
    x = batch.reshape(-1, batch.shape[-1]).to(self.mean.dtype)
    self.merge(x.mean(dim=0), x.var(dim=0, correction=0), x.shape[0])

  @torch.no_grad()
  def merge(self, bmean: torch.Tensor, bvar: torch.Tensor,
            bcount: int) -> None:
    """Fold a batch of `bcount` samples of mean `bmean` and population
    variance `bvar` into the statistics, in place (Chan's merge)."""
    delta = bmean - self.mean
    tot = self.count + bcount
    new_mean = self.mean + delta * (bcount / tot)
    m_a = self.var * self.count
    m_b = bvar * bcount
    m2 = m_a + m_b + torch.square(delta) * self.count * bcount / tot
    self.mean.copy_(new_mean)
    self.var.copy_(m2 / tot)
    self.count.copy_(tot)

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


def _std_key(tree: dict) -> str:
  return 'std' if 'std' in tree else 'log_std'


def _mlp_named(net: str, tree: dict) -> 'dict[str, np.ndarray]':
  """A flax MLP subtree as arrays under the names of `net`'s layers."""
  out = {}
  for i in range(len(tree)):
    dense = tree[f'Dense_{i}']
    out[f'{net}.layers.{i}.weight'] = np.asarray(dense['kernel']).T
    out[f'{net}.layers.{i}.bias'] = np.asarray(dense['bias'])
  return out


def flax_to_named(tree: dict) -> 'dict[str, np.ndarray]':
  """A flax tree of ActorCritic's layout ({'params': {'actor', 'critic',
  'std' | 'log_std'}}: parameters or an optimizer moment) as numpy arrays
  under the names of `ActorCritic.named_parameters()`."""
  tree = tree['params']
  return {**_mlp_named('actor', tree['actor']),
          **_mlp_named('critic', tree['critic']),
          'std_param': np.asarray(tree[_std_key(tree)])}


def _copy_(module: nn.Module, named: dict) -> None:
  """Copy numpy arrays into `module`'s parameters of the same names."""
  with torch.no_grad():
    for name, value in named.items():
      module.get_parameter(name).copy_(torch.tensor(np.asarray(value)))


def _mlp_dims(tree: dict) -> 'list[int]':
  """[in, hidden..., out] of a flax MLP subtree."""
  kernels = [np.asarray(tree[f'Dense_{i}']['kernel'])
             for i in range(len(tree))]
  return [kernels[0].shape[0]] + [k.shape[1] for k in kernels]


def actor_critic_from_numpy(params: dict, activation: str = 'elu',
                            device='cuda',
                            dtype=torch.float32) -> ActorCritic:
  """ActorCritic holding a flax parameter tree as numpy:
  params['params']['actor' | 'critic']['Dense_i']['kernel' | 'bias'] and
  params['params']['std' | 'log_std'] (which of the two names the noise
  std type)."""
  from mjlab_torch.physics.io import resolve_device
  dev = resolve_device(device)
  tree = params['params']
  a, c = _mlp_dims(tree['actor']), _mlp_dims(tree['critic'])
  net = ActorCritic(a[0], c[0], a[-1], a[1:-1], c[1:-1], activation,
                    noise_std_type='scalar' if _std_key(tree) == 'std'
                    else 'log')
  _copy_(net, flax_to_named(params))
  return net.to(device=dev, dtype=dtype)


def actor_from_numpy(params: dict, norm: 'dict | None' = None,
                     normalize_obs: bool = False, activation: str = 'elu',
                     device='cuda', dtype=torch.float32) -> Actor:
  """Actor from a flax parameter tree as numpy (the actor subtree of
  `actor_critic_from_numpy`'s layout) and the normalizer's
  {'mean', 'var'}."""
  from mjlab_torch.physics.io import resolve_device
  dev = resolve_device(device)
  dims = _mlp_dims(params['params']['actor'])
  actor = Actor(dims[0], dims[-1], dims[1:-1], activation, normalize_obs)
  _copy_(actor, _mlp_named('actor', params['params']['actor']))
  with torch.no_grad():
    if norm is not None:
      actor.norm.mean.copy_(torch.tensor(np.asarray(norm['mean'])))
      actor.norm.var.copy_(torch.tensor(np.asarray(norm['var'])))
  actor.requires_grad_(False)  # inference only
  return actor.to(device=dev, dtype=dtype).eval()


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
