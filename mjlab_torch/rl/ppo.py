"""PPO learner on the batched PyTorch environment.

Counterpart of mjlab_tpu/rl/ppo.py: a rollout of `num_steps_per_env`
env-steps into preallocated (T, N, ...) tensors on the env's device, GAE
with truncation bootstrapping, then epochs x minibatches of clipped PPO
updates with an adaptive-KL learning rate, `clip_by_global_norm` and Adam
written out as optax computes them. The JAX iteration is one XLA program;
here it is a stream of kernels that the host issues without reading a
value back: the rollout keeps the env's one host read an env-step and adds
none, the update reads none (the learning rate is a 0-d device tensor that
the adaptive rule sets with `torch.where`).

Random draws (initialisation, action noise, minibatch permutations) come
from the learner's own `torch.Generator` on the env's device, seeded from
`seed + 1`; the env keeps its own, seeded from `seed`. The learner runs in
float32 whatever the env's dtype, as the JAX learner does.

Sharded (the env's `world` has a process group, parallel/sharding.py):
every rank holds the same learner and collects on its own envs. What the
JAX package's GSPMD reduces over the env axis is reduced here by hand: the
normalizers' batch moments (merged from the ranks' means and variances:
two all-reduces an env-step), the advantages' mean and standard deviation
(the same merge), each minibatch's gradients with its loss terms and kl
(one all-reduce, then divided by the world size) and the iteration's logs
(one all-reduce). Action noise is drawn for every
rank's envs and cut to this rank's rows, so the learner's generator stays
in lockstep on every rank. Minibatches are stratified by rank: each rank
permutes its own samples with that generator and takes the same slice, so
a global minibatch is the union of the ranks' slices; at a world of one
this is the unsharded update. Under NCCL none of this reads the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from mjlab_torch.parallel.sharding import World, all_reduce_flat, broadcast_
from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg
from mjlab_torch.rl.networks import (
    ActorCritic,
    RunningNorm,
    flax_to_named,
    gaussian_entropy,
    gaussian_logprob,
)
from mjlab_torch.utils import tracing
from mjlab_torch.utils.math import ShardedGenerator, env_rows

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
UPDATE_LOGS = ('loss', 'pg', 'v', 'ent', 'kl')
_STAGE = tracing.stages('ppo.')


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


class StageClock:
  """`stage(name)` contexts that time a stage of a learn iteration without
  waiting for the device: CUDA events on a CUDA device (read by `ms()`,
  which waits for the last of them), the host clock on the CPU; each is
  also the span ppo.<name> under a profiler."""

  def __init__(self, device: torch.device):
    self.cuda = device.type == 'cuda'
    self.marks: 'dict[str, tuple]' = {}

  def _now(self):
    if not self.cuda:
      return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev

  @contextlib.contextmanager
  def __call__(self, name: str):
    with _STAGE(name):
      start = self._now()
      yield
      self.marks[name] = (start, self._now())

  def ms(self) -> 'dict[str, float]':
    out = {}
    for name, (a, b) in self.marks.items():
      if self.cuda:
        b.synchronize()
        out[f'{name}_ms'] = a.elapsed_time(b)
      else:
        out[f'{name}_ms'] = (b - a) * 1e3
    return out


class PPO:
  """PPO bound to a ManagerBasedRlEnv (or any env with its functional
  core: `init_state(seed)`, `step_fn`, `num_envs`, `action_dim`,
  `observation_dims`, `step_dt`, `device`). `step_fn` may wrap the env's."""

  def __init__(self, env, cfg: RslRlOnPolicyRunnerCfg,
               step_fn: 'Callable | None' = None):
    self.env = env
    self.cfg = cfg
    self.device = torch.device(env.device)
    # the env's world: its rank's envs are `env.num_envs` of world.num_envs
    self.world: World = (getattr(env, 'world', None)
                         or World(num_envs=env.num_envs, device=self.device))
    self._step_fn = step_fn or env.step_fn
    self.actor_groups = cfg.obs_groups['policy']
    self.critic_groups = cfg.obs_groups['critic']
    dims = env.observation_dims
    self.actor_dim = sum(dims[g] for g in self.actor_groups)
    self.critic_dim = sum(dims[g] for g in self.critic_groups)
    self.action_dim = env.action_dim
    # the rollout's storage and GAE's outputs, allocated on first use
    self.storage: 'Transition | None' = None
    self.advantages: 'torch.Tensor | None' = None
    self.returns: 'torch.Tensor | None' = None
    # cfg.video: env 0's qpos after each env-step of a rollout, (T, nq) on
    # the device, handed to the runner as logs['_qpos_env0'] (sharded, by
    # the rank that holds global env 0)
    self.record_qpos = bool(cfg.video) and self.world.offset == 0
    self.qpos_env0: 'torch.Tensor | None' = None

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
    w = self.world
    gen = (ShardedGenerator(self.device, (w.offset, w.n_local, w.num_envs))
           if w.sharded else torch.Generator(device=self.device))
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

  def _buffers(self, env_state=None) -> Transition:
    """The rollout's storage; with `env_state` given and the rollout
    recording, also the (T, nq) buffer of env 0's qpos (`qpos_env0`), of
    the env's dtype."""
    T, n, dev = self.cfg.num_steps_per_env, self.env.num_envs, self.device
    if self.storage is None:
      f = lambda *s, dtype=torch.float32: torch.zeros(
          (T, n) + s, dtype=dtype, device=dev)
      self.storage = Transition(
          actor_obs=f(self.actor_dim), critic_obs=f(self.critic_dim),
          action=f(self.action_dim), logprob=f(), mean=f(self.action_dim),
          value=f(), reward=f(), done=f(dtype=torch.bool),
          time_out=f(dtype=torch.bool))
      self.advantages, self.returns = f(), f()
    if self.record_qpos and self.qpos_env0 is None and env_state is not None:
      self.qpos_env0 = env_state.data.qpos.new_zeros(
          (T, env_state.data.qpos.shape[-1]))
    return self.storage

  @torch.no_grad()
  def _rollout(self, ts: TrainState):
    """num_steps_per_env env-steps from ts.env_state into the storage.
    Advances ts.env_state, ts.obs and both normalizers (every step, even
    with normalization off: their state is checkpointed). The stored
    observations are normalized with the statistics before that step's
    update; the bootstrap value with those after the last one. With
    `record_qpos`, env 0's qpos after each step goes into `qpos_env0` on
    the device, which nothing here reads. Returns (storage, last value,
    env extras stacked over the steps, episode stats)."""
    traj = self._buffers(ts.env_state)
    n, dev, f32 = self.env.num_envs, self.device, torch.float32
    reward_acc = torch.zeros(n, dtype=f32, device=dev)
    len_acc = torch.zeros(n, dtype=torch.int32, device=dev)
    ep_rew, ep_len, nresets = (torch.zeros((), dtype=f32, device=dev)
                               for _ in range(3))
    env_state, obs = ts.env_state, ts.obs
    step_extras = []
    clip = self.cfg.clip_actions
    for t in range(self.cfg.num_steps_per_env):
      with tracing.span('ppo.act'):
        a_obs, c_obs, a_n, c_n, mean, std, value = self._policy(ts, obs)
        self._update_norms(ts, a_obs, c_obs)
        action = mean + std * env_rows(ts.gen, lambda s: torch.randn(
            s, generator=ts.gen, device=dev), mean.shape)
        if clip is not None:
          action = action.clamp(-clip, clip)
        logprob = gaussian_logprob(mean, std, action)
      env_state, (next_obs, reward, terminated, truncated, extras) = \
          self._step_fn(env_state, action)
      reward = reward.to(f32)
      done = terminated | truncated
      # episode stats
      reward_acc += reward
      len_acc += 1
      ep_rew += torch.where(done, reward_acc, 0.0).sum()
      ep_len += torch.where(done, len_acc.to(f32), 0.0).sum()
      nresets += done.sum()
      reward_acc = torch.where(done, 0.0, reward_acc)
      len_acc = torch.where(done, 0, len_acc)
      for name, x in (('actor_obs', a_n), ('critic_obs', c_n),
                      ('action', action), ('logprob', logprob),
                      ('mean', mean), ('value', value), ('reward', reward),
                      ('done', done), ('time_out', extras['time_outs'])):
        getattr(traj, name)[t] = x
      step_extras.append({k: v for k, v in extras.items()
                          if k != 'time_outs'})
      if self.record_qpos:
        self.qpos_env0[t] = env_state.data.qpos[0]
      obs = _f32(next_obs)
    ts.env_state, ts.obs = env_state, obs
    last_value = self._policy(ts, obs)[-1]
    extras = {k: torch.stack([e[k].to(f32) for e in step_extras])
              for k in step_extras[0]}
    stats = {'ep_rew': ep_rew, 'ep_len': ep_len, 'nresets': nresets}
    return traj, last_value, extras, stats

  @torch.no_grad()
  def _update_norms(self, ts: TrainState, a_obs: torch.Tensor,
                    c_obs: torch.Tensor) -> None:
    """Fold one env-step's observations into both normalizers; sharded,
    the moments of every rank's envs (`_moments`: two all-reduces of both
    normalizers' moments in one buffer)."""
    if not self.world.sharded:
      ts.actor_norm.update(a_obs)
      ts.critic_norm.update(c_obs)
      return
    (ma, mc), (va, vc) = self._moments(
        [a_obs.mean(0), c_obs.mean(0)],
        [a_obs.var(0, correction=0), c_obs.var(0, correction=0)])
    n = a_obs.shape[0] * self.world.size
    ts.actor_norm.merge(ma, va, n)
    ts.critic_norm.merge(mc, vc, n)

  def _moments(self, means: 'list[torch.Tensor]',
               variances: 'list[torch.Tensor]'):
    """The mean and population variance over every rank's samples of each
    rank's (mean, population variance) pairs, ranks of equal sample counts:
    the mean of the means, then the mean of variance + (mean - global
    mean)^2 (Chan's merge, by two all-reduces; no sum of squares, which
    cancels in float32 on near-constant observations). One rank's pairs
    come back as they were, to the bit."""
    w = self.world
    glob = [m / w.size for m in all_reduce_flat(means, w)]
    spread = [v + torch.square(m_r - m)
              for v, m_r, m in zip(variances, means, glob)]
    return glob, [v / w.size for v in all_reduce_flat(spread, w)]

  def _normalized(self, x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-8) over every rank's `x` (population std)."""
    if not self.world.sharded:
      return (x - x.mean()) / (x.std(correction=0) + 1e-8)
    (mean,), (var,) = self._moments([x.mean()], [x.var(correction=0)])
    return (x - mean) / (torch.sqrt(var) + 1e-8)

  @torch.no_grad()
  def _gae(self, traj: Transition, last_value: torch.Tensor):
    """(advantages, returns) into their preallocated tensors. Truncation
    bootstrapping: reward + gamma V(s) on a time-out; `done` cuts the
    recursion."""
    alg = self.cfg.algorithm
    self._buffers()
    dt = traj.reward.dtype
    reward = traj.reward + alg.gamma * traj.value * traj.time_out.to(dt)
    not_done = 1.0 - traj.done.to(dt)
    adv, v_next = torch.zeros_like(last_value), last_value
    for t in reversed(range(reward.shape[0])):
      delta = reward[t] + alg.gamma * v_next * not_done[t] - traj.value[t]
      adv = delta + alg.gamma * alg.lam * not_done[t] * adv
      self.advantages[t] = adv
      v_next = traj.value[t]
    torch.add(self.advantages, traj.value, out=self.returns)
    return self.advantages, self.returns

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
    Returns the mean loss terms over the steps. Sharded, each step's
    gradients and loss terms are the means over every rank's slice."""
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
    world = self.world
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
        if world.sharded:
          *grads, terms = all_reduce_flat(
              list(grads) + [torch.stack([loss.detach(), pg, vl, ent, kl])],
              world)
          grads = [g / world.size for g in grads]
          loss, pg, vl, ent, kl = (terms / world.size).unbind()
        if alg.schedule == 'adaptive':
          ts.lr = adaptive_lr(ts.lr, kl, alg.desired_kl)
        adam_step_(params, clip_by_global_norm(grads, alg.max_grad_norm),
                   ts.adam, ts.lr)
        logs += torch.stack([loss.detach(), pg, vl, ent, kl])
    logs /= alg.num_learning_epochs * alg.num_mini_batches
    return dict(zip(UPDATE_LOGS, logs.unbind()))

  def _learn_iteration(self, ts: TrainState, stage=_STAGE):
    """Rollout, GAE and update; ts advances in place. `stage(name)` wraps
    'collection' and 'learning' (a timer's hook; by default the span
    ppo.<name>, nothing without a profiler). Returns (ts, logs), the logs
    as 0-d device tensors."""
    with stage('collection'):
      traj, last_value, extras, stats = self._rollout(ts)
    with stage('learning'):
      with tracing.span('ppo.gae'):
        adv, returns = self._gae(traj, last_value)
      with tracing.span('ppo.update'):
        logs = self._update(ts, traj, adv, returns)

    with torch.no_grad():
      logs.update(self._rollout_logs(traj, extras, stats))
      logs['lr'] = ts.lr
      logs['std'] = ts.net.std().mean()
    if self.record_qpos:
      logs['_qpos_env0'] = self.qpos_env0  # (T, nq), taken by the runner
    ts.iteration += 1
    return ts, logs

  def _rollout_logs(self, traj: Transition, extras: dict,
                    stats: dict) -> 'dict[str, torch.Tensor]':
    """The rollout's logs over every rank's envs, by one all-reduce when
    sharded. The env's extras are per env-step (T,): 'Episode_Termination/'
    counts are summed; 'Curriculum/' metrics are means over the envs,
    averaged over the ranks; the others are means over the envs that reset
    (weighted by the reset counts over the steps), reduced as their
    numerators and the counts."""
    world = self.world
    w = extras['reset_count'].clamp_min(0.0)
    keys = [k for k in extras if k != 'reset_count']
    num = lambda k: not k.startswith(('Episode_Termination', 'Curriculum/',
                                      'episode_length_sum'))
    parts = {'/reward': traj.reward.mean()[None],
             '/stats': torch.stack([stats['ep_rew'], stats['ep_len'],
                                    stats['nresets']]), '/w': w}
    parts.update({k: extras[k] * w if num(k) else extras[k] for k in keys})
    if world.sharded:
      parts = dict(zip(parts, all_reduce_flat(list(parts.values()), world)))
    ep_rew, ep_len, nresets = parts['/stats'].unbind()
    w = parts['/w']
    wsum = w.sum().clamp_min(1.0)
    logs = {'mean_reward':
                parts['/reward'][0] / world.size / self.env.step_dt,
            'mean_episode_reward': ep_rew / nresets.clamp_min(1.0),
            'resets': nresets}
    for k in keys:
      v = parts[k]
      if k == 'episode_length_sum':
        continue
      if k.startswith('Episode_Termination'):
        logs[k] = v.sum()
      elif k.startswith('Curriculum/'):
        logs[k] = (v / world.size * w).sum() / wsum
      else:
        logs[k] = v.sum() / wsum
    # true episode length from the env (the rollout-local counter would
    # cap at num_steps_per_env)
    if 'episode_length_sum' in extras:
      logs['mean_episode_length'] = parts['episode_length_sum'].sum() / wsum
    else:
      logs['mean_episode_length'] = ep_len / nresets.clamp_min(1.0)
    return logs

  def learn_iteration(self, ts: TrainState):
    """`_learn_iteration` with its collection and learning stages timed;
    logs['_clock'] is the StageClock, read by the runner when it logs."""
    clock = StageClock(self.device)
    ts, logs = self._learn_iteration(ts, stage=clock)
    logs['_clock'] = clock
    return ts, logs

  # inference
  def policy_fn(self, ts: TrainState):
    @torch.no_grad()
    def act(obs):
      a_obs = self._cat_obs(obs, self.actor_groups)
      if self.cfg.policy.actor_obs_normalization:
        a_obs = ts.actor_norm.normalize(a_obs)
      return ts.net.act_mean(a_obs)
    return act


def learner_tensors(ts: TrainState) -> 'list[torch.Tensor]':
  """The learner's tensors of `ts` in a fixed order: the parameters, Adam's
  count and moments, both normalizers and the learning rate."""
  out = [p.data for _, p in ts.net.named_parameters()]
  out.append(ts.adam.count)
  out += [ts.adam.mu[k] for k in sorted(ts.adam.mu)]
  out += [ts.adam.nu[k] for k in sorted(ts.adam.nu)]
  out += [b for _, b in ts.actor_norm.named_buffers()]
  out += [b for _, b in ts.critic_norm.named_buffers()]
  out.append(ts.lr)
  return out


def broadcast_learner(ts: TrainState, world: World) -> None:
  """Every rank's learner set in place to rank 0's."""
  broadcast_(learner_tensors(ts), world)


def _f32(obs: dict) -> dict:
  """Learner-visible observations in float32 (a float64 env's are cast)."""
  return {k: v.to(torch.float32) for k, v in obs.items()}


def _norm_from_numpy(norm, ref: RunningNorm) -> None:
  with torch.no_grad():
    for k in ('mean', 'var', 'count'):
      getattr(ref, k).copy_(torch.tensor(np.asarray(getattr(norm, k)))
                            .reshape(getattr(ref, k).shape))


def train_state_from_numpy(ppo: PPO, state, env_state=None,
                           obs: 'dict | None' = None) -> TrainState:
  """A TrainState of `ppo` holding the learner of a JAX TrainState as
  numpy (`jax.device_get(ts)`): `params` (flax tree), `opt_state` in
  optax's layout (`opt_state[1].inner_state[0]` is ScaleByAdamState(count,
  mu, nu), `opt_state[1].hyperparams['learning_rate']` the learning rate),
  `actor_norm` and `critic_norm` ({mean, var, count}) and `iteration`.
  The env's state and observations are `env_state` and `obs` if given
  (port objects), else a fresh `ppo.init_state()`'s, as is the learner's
  generator."""
  ts = ppo.init_state()
  dev = ppo.device
  as_t = lambda a: torch.tensor(np.asarray(a), device=dev)

  def named(tree):
    return {k: as_t(v).to(torch.float32)
            for k, v in flax_to_named(tree).items()}

  params = named(state.params)
  with torch.no_grad():
    for k, p in ts.net.named_parameters():
      p.copy_(params[k])
  inject = state.opt_state[1]
  adam = inject.inner_state[0]
  ts.adam = AdamState(count=as_t(adam.count).to(torch.int32).reshape(()),
                      mu=named(adam.mu), nu=named(adam.nu))
  ts.lr = as_t(inject.hyperparams['learning_rate']).to(
      torch.float32).reshape(())
  _norm_from_numpy(state.actor_norm, ts.actor_norm)
  _norm_from_numpy(state.critic_norm, ts.critic_norm)
  ts.iteration = int(state.iteration)
  if env_state is not None:
    ts.env_state = env_state
  if obs is not None:
    ts.obs = _f32(obs)
  return ts
