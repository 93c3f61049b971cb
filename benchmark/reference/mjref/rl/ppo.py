"""PPO learner on the batched environment, in plain torch: what the
benchmark's check follows of one iteration.

Counterpart of mjlab_tpu/rl/ppo.py, on one process: the learner's state
from the seed, the policy's forward, GAE with truncation bootstrapping, and
epochs x minibatches of clipped PPO updates with an adaptive-KL learning
rate, `clip_by_global_norm` and Adam written out as optax computes them.
The rollout is not here: the check takes the program's captured rollout
and recomputes its forward pass.

Random draws (initialisation, minibatch permutations) come from the
learner's own `torch.Generator` on the env's device, seeded from
`seed + 1`; the env keeps its own, seeded from `seed`. The learner runs in
float32 whatever the env's dtype, as the JAX learner does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mjref.rl.config import RslRlOnPolicyRunnerCfg
from mjref.rl.networks import (
    ActorCritic,
    RunningNorm,
    gaussian_entropy,
    gaussian_logprob,
)

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
UPDATE_LOGS = ('loss', 'pg', 'v', 'ent', 'kl')


@dataclasses.dataclass
class AdamState:
  """optax's ScaleByAdamState: the step count (int32) and the first and
  second moments by parameter name."""
  count: torch.Tensor
  mu: 'dict[str, torch.Tensor]'
  nu: 'dict[str, torch.Tensor]'


@dataclasses.dataclass
class TrainState:
  net: ActorCritic
  adam: AdamState
  actor_norm: RunningNorm
  critic_norm: RunningNorm
  lr: torch.Tensor  # 0-d, on the env's device
  env_state: Any
  obs: dict
  gen: torch.Generator  # the learner's
  iteration: int


@dataclasses.dataclass
class Transition:
  actor_obs: torch.Tensor
  critic_obs: torch.Tensor
  action: torch.Tensor
  logprob: torch.Tensor
  mean: torch.Tensor
  value: torch.Tensor
  reward: torch.Tensor
  done: torch.Tensor
  time_out: torch.Tensor


def clip_by_global_norm(grads: 'list[torch.Tensor]',
                        max_norm: float) -> 'list[torch.Tensor]':
  """optax.clip_by_global_norm: scale every gradient by max_norm / g_norm
  when the global norm g_norm reaches max_norm, else leave it. (Not
  torch.nn.utils.clip_grad_norm_, which divides by g_norm + 1e-6.)"""
  g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
  keep = g_norm < max_norm
  return [torch.where(keep, g, g / g_norm * max_norm) for g in grads]


@torch.no_grad()
def adam_step_(params: 'dict[str, torch.Tensor]',
               grads: 'list[torch.Tensor]', state: AdamState,
               lr: torch.Tensor) -> None:
  """One optax.adam step (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) at the
  learning rate `lr`, in place on `params` and `state`, in optax's order
  of operations. The bias corrections are taken in float64 and rounded
  once, as optax does them under 64-bit JAX."""
  state.count += 1
  n = state.count.double()
  bc1 = (1 - ADAM_B1 ** n).float()
  bc2 = (1 - ADAM_B2 ** n).float()
  for (name, p), g in zip(params.items(), grads):
    mu = (1 - ADAM_B1) * g + ADAM_B1 * state.mu[name]
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[name]
    state.mu[name], state.nu[name] = mu, nu
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
    p.add_(update * -lr)


def adaptive_lr(lr: torch.Tensor, kl: torch.Tensor,
                desired_kl: float) -> torch.Tensor:
  """rsl_rl's adaptive schedule, on the device: lr / 1.5 (not under 1e-5)
  when kl > 2 desired_kl; lr * 1.5 (not over 1e-2) when
  0 < kl < desired_kl / 2; else lr."""
  lr = torch.where(kl > desired_kl * 2.0, (lr / 1.5).clamp_min(1e-5), lr)
  return torch.where((kl < desired_kl / 2.0) & (kl > 0.0),
                     (lr * 1.5).clamp_max(1e-2), lr)


class PPO:
  """PPO bound to a ManagerBasedRlEnv (its `init_state(seed)`,
  `action_dim`, `observation_dims` and `device`)."""

  def __init__(self, env, cfg: RslRlOnPolicyRunnerCfg):
    self.env = env
    self.cfg = cfg
    self.device = torch.device(env.device)
    self.actor_groups = cfg.obs_groups['policy']
    self.critic_groups = cfg.obs_groups['critic']
    dims = env.observation_dims
    self.actor_dim = sum(dims[g] for g in self.actor_groups)
    self.critic_dim = sum(dims[g] for g in self.critic_groups)
    self.action_dim = env.action_dim

  # ------------------------------------------------------------------
  def _cat_obs(self, obs: dict, groups) -> torch.Tensor:
    return torch.cat([obs[g] for g in groups], dim=-1)

  def init_net(self, gen: 'torch.Generator | None' = None) -> ActorCritic:
    pol = self.cfg.policy
    return ActorCritic(
        self.actor_dim, self.critic_dim, self.action_dim,
        tuple(pol.actor_hidden_dims), tuple(pol.critic_hidden_dims),
        pol.activation, pol.init_noise_std, pol.noise_std_type,
        device=self.device, generator=gen)

  def init_state(self, seed: 'int | None' = None) -> TrainState:
    seed = self.cfg.seed if seed is None else seed
    env_state, obs = self.env.init_state(seed)
    gen = torch.Generator(device=self.device)
    gen.manual_seed(seed + 1)
    net = self.init_net(gen)
    zeros = {k: torch.zeros_like(p) for k, p in net.named_parameters()}
    return TrainState(
        net=net,
        adam=AdamState(
            count=torch.zeros((), dtype=torch.int32, device=self.device),
            mu=zeros, nu={k: z.clone() for k, z in zeros.items()}),
        actor_norm=RunningNorm.create(self.actor_dim, self.device),
        critic_norm=RunningNorm.create(self.critic_dim, self.device),
        lr=torch.tensor(self.cfg.algorithm.learning_rate,
                        dtype=torch.float32, device=self.device),
        env_state=env_state, obs=_f32(obs), gen=gen, iteration=0)

  # ------------------------------------------------------------------
  def _policy(self, ts: TrainState, obs: dict):
    a_obs = self._cat_obs(obs, self.actor_groups)
    c_obs = self._cat_obs(obs, self.critic_groups)
    pol = self.cfg.policy
    a_obs_n = (ts.actor_norm.normalize(a_obs) if pol.actor_obs_normalization
               else a_obs)
    c_obs_n = (ts.critic_norm.normalize(c_obs)
               if pol.critic_obs_normalization else c_obs)
    mean, std, value = ts.net(a_obs_n, c_obs_n)
    return a_obs, c_obs, a_obs_n, c_obs_n, mean, std, value

  def _normalized(self, x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-8) (population std)."""
    return (x - x.mean()) / (x.std(correction=0) + 1e-8)

  @torch.no_grad()
  def _gae(self, traj: Transition, last_value: torch.Tensor):
    """(advantages, returns). Truncation bootstrapping: reward + gamma V(s)
    on a time-out; `done` cuts the recursion."""
    alg = self.cfg.algorithm
    advantages = torch.zeros_like(traj.value)
    dt = traj.reward.dtype
    reward = traj.reward + alg.gamma * traj.value * traj.time_out.to(dt)
    not_done = 1.0 - traj.done.to(dt)
    adv, v_next = torch.zeros_like(last_value), last_value
    for t in reversed(range(reward.shape[0])):
      delta = reward[t] + alg.gamma * v_next * not_done[t] - traj.value[t]
      adv = delta + alg.gamma * alg.lam * not_done[t] * adv
      advantages[t] = adv
      v_next = traj.value[t]
    return advantages, advantages + traj.value

  def _loss(self, net: ActorCritic, mb: tuple, old_std: torch.Tensor):
    """(loss, (pg, v, ent, kl)) of one minibatch, its advantages already
    normalized; kl is detached."""
    alg = self.cfg.algorithm
    o_a, o_c, act, old_lp, old_mean, old_v, a, ret = mb
    mean = net.act_mean(o_a)
    std = net.std()
    value = net.value(o_c)
    lp = gaussian_logprob(mean, std, act)
    ratio = torch.exp(lp - old_lp)
    surr1 = -a * ratio
    surr2 = -a * ratio.clamp(1 - alg.clip_param, 1 + alg.clip_param)
    pg_loss = torch.maximum(surr1, surr2).mean()
    if alg.use_clipped_value_loss:
      v_clipped = old_v + (value - old_v).clamp(-alg.clip_param,
                                                alg.clip_param)
      v_loss = torch.maximum(torch.square(value - ret),
                             torch.square(v_clipped - ret)).mean()
    else:
      v_loss = torch.square(value - ret).mean()
    ent = gaussian_entropy(std).mean()
    loss = pg_loss + alg.value_loss_coef * v_loss - alg.entropy_coef * ent
    with torch.no_grad():
      # analytic Gaussian KL for the adaptive schedule (rsl_rl formula)
      kl = torch.sum(torch.log(std / old_std + 1e-10)
                     + (torch.square(old_std) + torch.square(old_mean - mean))
                     / (2.0 * torch.square(std)) - 0.5, dim=-1).mean()
    return loss, (pg_loss.detach(), v_loss.detach(), ent.detach(), kl)

  def _update(self, ts: TrainState, traj: Transition, adv: torch.Tensor,
              returns: torch.Tensor) -> 'dict[str, torch.Tensor]':
    """num_learning_epochs x num_mini_batches Adam steps on ts.net, in
    place; the learning rate is set before the step of the same minibatch.
    Returns the mean loss terms over the steps."""
    alg = self.cfg.algorithm
    T, N = traj.reward.shape
    batch = T * N
    mb = batch // alg.num_mini_batches
    flat = [x.reshape((batch,) + x.shape[2:]) for x in (
        traj.actor_obs, traj.critic_obs, traj.action, traj.logprob,
        traj.mean, traj.value)]
    adv_f = adv.reshape(batch)
    if not alg.normalize_advantage_per_mini_batch:
      adv_f = self._normalized(adv_f)
    flat += [adv_f, returns.reshape(batch)]
    net = ts.net
    params = dict(net.named_parameters())
    with torch.no_grad():
      old_std = net.std()
    logs = torch.zeros(len(UPDATE_LOGS), device=self.device)
    for _ in range(alg.num_learning_epochs):
      perm = torch.randperm(batch, generator=ts.gen, device=self.device)
      for i in range(alg.num_mini_batches):
        idx = perm[i * mb:(i + 1) * mb]
        batch_i = [x[idx] for x in flat]
        if alg.normalize_advantage_per_mini_batch:
          batch_i[6] = self._normalized(batch_i[6])
        loss, (pg, vl, ent, kl) = self._loss(net, tuple(batch_i), old_std)
        grads = torch.autograd.grad(loss, list(params.values()))
        if alg.schedule == 'adaptive':
          ts.lr = adaptive_lr(ts.lr, kl, alg.desired_kl)
        adam_step_(params, clip_by_global_norm(grads, alg.max_grad_norm),
                   ts.adam, ts.lr)
        logs += torch.stack([loss.detach(), pg, vl, ent, kl])
    logs /= alg.num_learning_epochs * alg.num_mini_batches
    return dict(zip(UPDATE_LOGS, logs.unbind()))


def _f32(obs: dict) -> dict:
  """Learner-visible observations in float32 (a float64 env's are cast)."""
  return {k: v.to(torch.float32) for k, v in obs.items()}
