"""The port's PPO learner against the JAX package's, on the CPU in float32:
ActorCritic, log-prob, entropy, RunningNorm.update, GAE, global-norm
clipping, the update and two whole learn iterations (the second from a
carried JAX TrainState), plus the adaptive learning-rate rule and the fresh
initialisation.

Weights and state cross over with `actor_critic_from_numpy` and
`train_state_from_numpy`. Both learners run a deterministic toy env
written here for each framework: observations are read from one numpy
table by step, episodes truncate every third step and terminate on a
table value, and with `clip_actions=0.0` every action is exactly 0, so the
rollout, its log-probs and the update do not depend on a noise draw, which
the two frameworks cannot share.

Where a port goes wrong, and the test that holds it:
- population statistics (jnp.std and jnp.var are ddof 0, torch's are not
  by default): test_running_norm_chain_matches_jax, test_update_matches_jax;
- the normalizer's order (stored observations normalized before the step's
  update, the bootstrap value after the last one; both normalizers updated
  with normalization off): test_learn_iteration_matches_jax;
- optax's global-norm clipping (scale by max_norm / g_norm only when
  g_norm >= max_norm): test_clip_by_global_norm_matches_optax;
- the adaptive rule at KL = 0: test_adaptive_lr_rule (the parity tests run
  the 'fixed' schedule);
- Adam's first step is lr * sign(g): test_update_matches_jax (moments held
  tightly, parameters within a bound that allows a sign flip);
- truncation bootstrapping and `done`: test_gae_matches_jax;
- log weighting by reset counts: test_learn_iteration_matches_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mjlab_tpu.rl import ppo as jppo_mod
from mjlab_tpu.rl.config import RslRlOnPolicyRunnerCfg as JaxCfg
from mjlab_tpu.rl.networks import ActorCritic as JaxActorCritic
from mjlab_tpu.rl.networks import RunningNorm as JaxRunningNorm
from mjlab_tpu.rl.networks import gaussian_entropy as jax_entropy
from mjlab_tpu.rl.networks import gaussian_logprob as jax_logprob
from mjlab_torch.rl import networks as tnet
from mjlab_torch.rl import ppo as tppo_mod
from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg as TorchCfg
import torch_parity  # noqa: F401  (one intra-op thread)

N_ENVS, NSTEP_TABLE = 6, 64
POLICY_DIM, CRITIC_DIM, ACTION_DIM = 5, 3, 2
TABLE = np.random.default_rng(7).normal(
    size=(NSTEP_TABLE, N_ENVS, POLICY_DIM + CRITIC_DIM + 1)).astype(np.float32)


class JaxToyEnv:
  """The deterministic toy env on jax.numpy (float32 under x64)."""

  num_envs = N_ENVS
  action_dim = ACTION_DIM
  observation_dims = {'policy': POLICY_DIM, 'critic': CRITIC_DIM}
  step_dt = 0.02

  def __init__(self):
    self.table = jnp.asarray(TABLE)

  def _obs(self, k):
    row = self.table[k % NSTEP_TABLE]
    return {'policy': row[:, :POLICY_DIM],
            'critic': row[:, POLICY_DIM:POLICY_DIM + CRITIC_DIM]}

  def init_state(self, seed=0):
    del seed
    state = {'k': jnp.zeros((), jnp.int32),
             't': jnp.arange(N_ENVS, dtype=jnp.int32) % 3}
    return state, self._obs(state['k'])

  @property
  def step_fn(self):
    def step(state, action):
      k, t = state['k'], state['t']
      row = self.table[k % NSTEP_TABLE]
      target = row[:, :2]
      reward = (-jnp.sum(jnp.square(action - target), axis=-1)
                + 0.1 * row[:, POLICY_DIM]).astype(jnp.float32)
      t = t + 1
      truncated = t >= 3
      terminated = (row[:, -1] > 1.0) & ~truncated
      done = truncated | terminated
      f = lambda x: jnp.sum(x).astype(jnp.float32)
      extras = {
          'time_outs': truncated,
          'reset_count': f(done),
          'episode_length_sum': f(jnp.where(done, t, 0)),
          'Episode_Termination/time_out': f(truncated),
          'Episode_Termination/bad': f(terminated),
          'Episode_Reward/r': f(jnp.where(done, reward, 0.0))
          / jnp.maximum(f(done), 1.0),
      }
      state = {'k': k + 1, 't': jnp.where(done, 0, t)}
      return state, (self._obs(k + 1), reward, terminated, truncated, extras)
    return step


class TorchToyEnv:
  """The same toy env on torch."""

  num_envs = N_ENVS
  action_dim = ACTION_DIM
  observation_dims = {'policy': POLICY_DIM, 'critic': CRITIC_DIM}
  step_dt = 0.02
  device = torch.device('cpu')

  def __init__(self):
    self.table = torch.from_numpy(TABLE)

  def _obs(self, k):
    row = self.table[int(k) % NSTEP_TABLE]
    return {'policy': row[:, :POLICY_DIM],
            'critic': row[:, POLICY_DIM:POLICY_DIM + CRITIC_DIM]}

  def init_state(self, seed=0):
    del seed
    state = {'k': torch.zeros((), dtype=torch.int32),
             't': torch.arange(N_ENVS, dtype=torch.int32) % 3}
    return state, self._obs(state['k'])

  @property
  def step_fn(self):
    def step(state, action):
      k, t = state['k'], state['t']
      row = self.table[int(k) % NSTEP_TABLE]
      target = row[:, :2]
      reward = (-torch.sum(torch.square(action - target), dim=-1)
                + 0.1 * row[:, POLICY_DIM])
      t = t + 1
      truncated = t >= 3
      terminated = (row[:, -1] > 1.0) & ~truncated
      done = truncated | terminated
      f = lambda x: torch.sum(x).to(torch.float32)
      extras = {
          'time_outs': truncated,
          'reset_count': f(done),
          'episode_length_sum': f(torch.where(done, t, 0)),
          'Episode_Termination/time_out': f(truncated),
          'Episode_Termination/bad': f(terminated),
          'Episode_Reward/r': f(torch.where(done, reward, 0.0))
          / f(done).clamp_min(1.0),
      }
      state = {'k': k + 1, 't': torch.where(done, 0, t)}
      return state, (self._obs(k + 1), reward, terminated, truncated, extras)
    return step


def _cfgs(**alg):
  """The same small runner cfg for both packages: clip_actions 0, fixed
  schedule, one minibatch, two epochs."""
  out = []
  for cls in (JaxCfg, TorchCfg):
    cfg = cls(num_steps_per_env=4, clip_actions=0.0, seed=3)
    cfg.policy.actor_hidden_dims = (16, 8)
    cfg.policy.critic_hidden_dims = (12,)
    cfg.policy.init_noise_std = 0.8
    a = cfg.algorithm
    a.schedule, a.num_mini_batches, a.num_learning_epochs = 'fixed', 1, 2
    a.learning_rate = 3e-3
    for k, v in alg.items():
      setattr(a, k, v)
    out.append(cfg)
  return out


def _learners(**alg):
  jcfg, tcfg = _cfgs(**alg)
  jppo = jppo_mod.PPO(JaxToyEnv(), jcfg)
  tppo = tppo_mod.PPO(TorchToyEnv(), tcfg)
  return jppo, tppo


def _close(got, want, rel, what=''):
  """max |got - want| <= rel * (1 + max |want|)."""
  got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want, dtype=np.float64)
  np.testing.assert_allclose(got, want, rtol=0,
                             atol=rel * (1 + np.abs(want).max()),
                             err_msg=what)


# ---------------------------------------------------------------------------
# networks


@pytest.mark.parametrize('noise', ['scalar', 'log'])
@pytest.mark.parametrize('hidden', [(32, 16), (24,)])
@pytest.mark.parametrize('activation', ['elu', 'gelu'])
def test_actor_critic_matches_flax(noise, hidden, activation):
  """Mean, std and value against flax's ActorCritic.apply on random
  parameters (std values below the 1e-4 clamp included); 1e-6 of the
  outputs' scale, float32. gelu is flax's tanh approximation."""
  rng = np.random.default_rng(len(hidden) + (noise == 'log'))
  a_obs = rng.normal(size=(64, 11)).astype(np.float32)
  c_obs = rng.normal(size=(64, 7)).astype(np.float32)
  net = JaxActorCritic(action_dim=4, actor_hidden_dims=hidden,
                       critic_hidden_dims=hidden[::-1],
                       activation=activation, init_noise_std=0.7,
                       noise_std_type=noise)
  params = jax.tree.map(np.asarray, net.init(
      jax.random.PRNGKey(1), jnp.asarray(a_obs), jnp.asarray(c_obs)))
  key = 'std' if noise == 'scalar' else 'log_std'
  std = rng.uniform(-0.2, 1.0, size=4).astype(np.float32)
  std[0] = 5e-5  # under the clamp
  params['params'][key] = std
  want = [np.asarray(x) for x in net.apply(params, jnp.asarray(a_obs),
                                           jnp.asarray(c_obs))]
  tn = tnet.actor_critic_from_numpy(params, activation, device='cpu')
  assert tn.noise_std_type == noise
  got = tn(torch.from_numpy(a_obs), torch.from_numpy(c_obs))
  for g, w, what in zip(got, want, ('mean', 'std', 'value')):
    assert tuple(g.shape) == w.shape, what
    _close(g, w, 1e-6, what)
  # every parameter carried across, under its own name
  named = tnet.flax_to_named(params)
  assert set(named) == {k for k, _ in tn.named_parameters()}
  for k, p in tn.named_parameters():
    np.testing.assert_array_equal(p.detach().numpy(), named[k], err_msg=k)


def test_logprob_and_entropy_match_jax():
  rng = np.random.default_rng(0)
  mean = rng.normal(size=(50, 6)).astype(np.float32)
  action = (mean + rng.normal(size=(50, 6))).astype(np.float32)
  std = rng.uniform(0.05, 2.0, size=6).astype(np.float32)
  t = lambda x: torch.from_numpy(x)
  _close(tnet.gaussian_logprob(t(mean), t(std), t(action)),
         jax_logprob(jnp.asarray(mean), jnp.asarray(std),
                     jnp.asarray(action)), 1e-6)
  _close(tnet.gaussian_entropy(t(std)), jax_entropy(jnp.asarray(std)), 1e-6)


def test_running_norm_chain_matches_jax():
  """Five updates of batches of different sizes, scales and offsets: mean,
  population variance and count within 1e-6 relative."""
  rng = np.random.default_rng(1)
  jn, tn = JaxRunningNorm.create(5), tnet.RunningNorm.create(5)
  for i, n in enumerate((7, 64, 1, 300, 33)):
    x = (rng.normal(size=(n, 5)) * (1 + i) + 3 * i).astype(np.float32)
    jn = jn.update(jnp.asarray(x))
    tn.update(torch.from_numpy(x))
    for k in ('mean', 'var', 'count'):
      want = np.asarray(getattr(jn, k), np.float64)
      np.testing.assert_allclose(getattr(tn, k).numpy(), want, rtol=1e-6,
                                 atol=1e-6 * np.abs(want).max(),
                                 err_msg=f'{k} after update {i}')


def test_fresh_init_is_flax_default():
  """A fresh learner at the registered widths: each kernel's std within
  4/sqrt(n) + 1% of sqrt(1/fan_in) (the sample std of n draws of a
  normal truncated at 2 sigma has a relative spread of ~0.63/sqrt(n)),
  every draw within the truncation, zero biases, std = init_noise_std."""
  cfg = TorchCfg(device='cpu')
  ppo = tppo_mod.PPO(TorchToyEnv(), cfg)
  ppo.actor_dim, ppo.critic_dim, ppo.action_dim = 99, 198, 29
  gen = torch.Generator().manual_seed(43)
  net = ppo.init_net(gen)
  for name, p in net.state_dict().items():
    if name.endswith('weight'):
      n, fan_in = p.numel(), p.shape[1]
      sigma = (1.0 / fan_in) ** 0.5
      ratio = float(p.std()) / sigma
      assert abs(ratio - 1) <= 4 / n ** 0.5 + 0.01, (name, ratio)
      assert float(p.abs().max()) <= 2 * sigma / 0.87962566103423978 + 1e-7
    elif name.endswith('bias'):
      assert float(p.abs().max()) == 0.0, name
  assert torch.equal(net.std().detach(), torch.full((29,), 1.0))
  assert [tuple(l.weight.shape) for l in net.critic.layers] == [
      (512, 198), (256, 512), (128, 256), (1, 128)]


# ---------------------------------------------------------------------------
# pieces of the learner


def test_gae_matches_jax():
  """The inputs of tests/test_rl.py::test_gae_matches_reference_loop
  through both packages' _gae; 1e-6."""
  jppo, tppo = _learners()
  T, N = 6, 4
  rng = np.random.default_rng(0)
  reward = rng.normal(size=(T, N)).astype(np.float32)
  value = rng.normal(size=(T, N)).astype(np.float32)
  done = rng.uniform(size=(T, N)) < 0.2
  time_out = done & (rng.uniform(size=(T, N)) < 0.5)
  last_value = rng.normal(size=N).astype(np.float32)
  assert done.any() and time_out.any()
  z = np.zeros((T, N), np.float32)
  fields = dict(actor_obs=z, critic_obs=z, action=z, logprob=z, mean=z,
                value=value, reward=reward, done=done, time_out=time_out)
  jadv, jret = jppo._gae(
      jppo_mod.Transition(**{k: jnp.asarray(v) for k, v in fields.items()}),
      jnp.asarray(last_value))
  tppo.cfg.num_steps_per_env, tppo.env.num_envs = T, N
  tadv, tret = tppo._gae(
      tppo_mod.Transition(**{k: torch.from_numpy(v)
                             for k, v in fields.items()}),
      torch.from_numpy(last_value))
  _close(tadv, jadv, 1e-6, 'advantages')
  _close(tret, jret, 1e-6, 'returns')


@pytest.mark.parametrize('scale', [0.01, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
  """Below the limit the gradients pass unchanged; above it they are
  scaled to the limit, as optax does (g / g_norm * max_norm)."""
  rng = np.random.default_rng(2)
  grads = [(scale * rng.normal(size=s)).astype(np.float32)
           for s in ((3, 4), (4,), (1,))]
  want, _ = optax.clip_by_global_norm(1.0).update(
      [jnp.asarray(g) for g in grads], None)
  got = tppo_mod.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                     1.0)
  norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                           for g in grads)))
  assert (norm < 1.0) == (scale == 0.01)
  for g, w, raw in zip(got, want, grads):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    if norm < 1.0:
      np.testing.assert_array_equal(g.numpy(), raw)


@pytest.mark.parametrize('kl,factor', [
    (0.05, 1 / 1.5),  # above 2x desired
    (0.02, 1.0),  # exactly 2x: unchanged
    (0.001, 1.5),  # below 1/2 desired
    (0.0, 1.0),  # exactly 0: unchanged (kl > 0 is required)
    (-1e-9, 1.0),  # negative (rounding): unchanged
    (0.01, 1.0),  # in between
])
def test_adaptive_lr_rule(kl, factor):
  desired = 0.01
  for lr in (1e-3, 1.2e-5, 8e-3):
    got = tppo_mod.adaptive_lr(torch.tensor(lr, dtype=torch.float32),
                               torch.tensor(kl, dtype=torch.float32),
                               desired)
    lr32 = np.float32(lr)
    if factor < 1:
      want = max(lr32 / np.float32(1.5), np.float32(1e-5))
    elif factor > 1:
      want = min(lr32 * np.float32(1.5), np.float32(1e-2))
    else:
      want = lr32
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == float(np.float32(want)), (kl, lr, float(got))


def _carried(jppo, tppo, jts):
  """The port's TrainState holding the JAX TrainState `jts`: its learner
  by train_state_from_numpy, the toy env's state and observations as
  tensors."""
  host = jax.device_get(jts)
  env_state = {k: torch.from_numpy(np.array(v)) for k, v in
               host.env_state.items()}
  obs = {k: torch.from_numpy(np.array(v)) for k, v in host.obs.items()}
  return tppo_mod.train_state_from_numpy(tppo, host, env_state=env_state,
                                         obs=obs)


def _check_learner(tts, jts, what, steps, lr, rel=1e-5):
  """The port's learner state against the JAX one: Adam count, both
  moments within `rel` of their scale, normalizers and lr within 1e-6,
  and the parameters after `steps` Adam steps at `lr`.

  Adam moves an element by lr * mu_hat / (sqrt(nu_hat) + eps), ~lr * sign(g)
  on its first step: an element whose gradient is within rounding of 0
  (the frameworks' gradients differ by ~1e-6 of their scale) may step
  either way, and the two parameters then differ by up to 2 lr a step. So
  elements whose first moment is at least 1e-5 of their tensor's largest
  are held within 1e-6 (observed: 1e-8 to 1.2e-7), and the rest within
  2 lr steps."""
  host = jax.device_get(jts)
  adam = host.opt_state[1].inner_state[0]
  assert int(tts.adam.count) == int(adam.count), what
  mu, nu = tnet.flax_to_named(adam.mu), tnet.flax_to_named(adam.nu)
  params = tnet.flax_to_named(host.params)
  for name, p in tts.net.named_parameters():
    _close(tts.adam.mu[name], mu[name], rel, f'{what}: mu {name}')
    _close(tts.adam.nu[name], nu[name], rel, f'{what}: nu {name}')
    diff = np.abs(p.detach().numpy() - params[name])
    tight = np.abs(mu[name]) >= 1e-5 * np.abs(mu[name]).max()
    assert diff[tight].max(initial=0) <= 1e-6, (what, name, diff.max())
    assert diff.max() <= 2 * lr * steps + 1e-6, (what, name, diff.max())
  for k in ('mean', 'var', 'count'):
    for tn, jn in ((tts.actor_norm, host.actor_norm),
                   (tts.critic_norm, host.critic_norm)):
      _close(getattr(tn, k), getattr(jn, k), 1e-6, f'{what}: norm {k}')
  _close(tts.lr, host.lr, 1e-6, f'{what}: lr')
  assert tts.iteration == int(host.iteration), what


def _update_inputs(T=3, N=8, seed=4):
  rng = np.random.default_rng(seed)
  f = lambda *s: rng.normal(size=(T, N) + s).astype(np.float32)
  fields = dict(actor_obs=f(POLICY_DIM), critic_obs=f(POLICY_DIM + CRITIC_DIM),
                action=f(ACTION_DIM), logprob=f() - 3.0,
                mean=f(ACTION_DIM), value=f(), reward=f(),
                done=np.zeros((T, N), bool), time_out=np.zeros((T, N), bool))
  return fields, f(), f()


@pytest.mark.parametrize('epochs', [1, 2])
def test_update_matches_jax(epochs):
  """_update on the same parameters, trajectory and advantages, one
  minibatch (the loss is a mean over the whole batch, so the shuffle only
  reorders a sum). One epoch: Adam's moments (0.1 g and 0.001 g^2 of the
  clipped first gradient) within 1e-5 of their scale, and the loss terms
  within 1e-6. Two epochs: moments within 1e-5, loss terms within 1e-5.
  Parameters as _check_learner states, with Adam's sign step in mind."""
  jppo, tppo = _learners(num_learning_epochs=epochs, max_grad_norm=0.5)
  jts = jppo.init_state(0)
  tts = _carried(jppo, tppo, jts)
  fields, adv, ret = _update_inputs()
  jtraj = jppo_mod.Transition(**{k: jnp.asarray(v) for k, v in fields.items()})
  jparams, jopt, jlr, _, jlogs = jax.jit(jppo._update)(
      jts, jtraj, jnp.asarray(adv), jnp.asarray(ret), jax.random.PRNGKey(5))
  tlogs = tppo._update(
      tts, tppo_mod.Transition(**{k: torch.from_numpy(v)
                                  for k, v in fields.items()}),
      torch.from_numpy(adv), torch.from_numpy(ret))
  tol_logs = 1e-6 if epochs == 1 else 1e-5
  for k in tppo_mod.UPDATE_LOGS:
    _close(tlogs[k], jlogs[k], tol_logs, f'log {k}')
  _check_learner(tts, jts.replace(params=jparams, opt_state=jopt, lr=jlr),
                 f'{epochs} epochs', epochs, tppo.cfg.algorithm.learning_rate)


def test_learn_iteration_matches_jax():
  """Two whole learn iterations on the toy env. Iteration 1 from one
  initial state; iteration 2 from JAX's TrainState after iteration 1,
  carried into a fresh port learner. Each: the rollout's buffers (the
  observations and flags exactly, the rewards and the network outputs
  within 1e-6), advantages and
  returns within 1e-5, every log within 1e-5 (the episode logs weighted by
  reset counts, the termination counts summed), then the learner state as
  in test_update_matches_jax."""
  jppo, tppo = _learners()
  jts = jppo.init_state(0)
  tts = _carried(jppo, tppo, jts)
  rollout = jax.jit(jppo._rollout)
  lr = tppo.cfg.algorithm.learning_rate
  for it in (1, 2):
    if it == 2:
      tppo = tppo_mod.PPO(TorchToyEnv(), tppo.cfg)
      tts = _carried(jppo, tppo, jts)
    jr = jax.device_get(rollout(jts))
    jtraj, jlast = jr[3], jr[4]
    jadv, jret = jax.device_get(jppo._gae(jtraj, jlast))
    jts, jlogs = jppo.learn_iteration(jts)
    jlogs = jax.device_get(jlogs)
    tts, tlogs = tppo.learn_iteration(tts)
    tlogs.pop('_clock')
    traj = tppo.storage
    for k in ('actor_obs', 'critic_obs', 'action', 'done', 'time_out'):
      np.testing.assert_array_equal(getattr(traj, k).numpy(),
                                    np.asarray(getattr(jtraj, k)),
                                    err_msg=f'iteration {it}: {k}')
    assert float(traj.action.abs().max()) == 0.0
    assert bool(traj.done.any()) and bool(traj.time_out.any())
    assert bool((traj.done & ~traj.time_out).any())
    for k in ('logprob', 'mean', 'value', 'reward'):
      _close(getattr(traj, k), getattr(jtraj, k), 1e-6,
             f'iteration {it}: {k}')
    _close(tppo.advantages, jadv, 1e-5, f'iteration {it}: advantages')
    _close(tppo.returns, jret, 1e-5, f'iteration {it}: returns')
    assert set(tlogs) == set(jlogs) - {'_qpos_env0'}
    for k in tlogs:
      _close(tlogs[k], jlogs[k], 1e-5, f'iteration {it}: log {k}')
    _check_learner(tts, jts, f'iteration {it}', 2, lr)
