"""The two ways a cell drives the port: `train` (PPO iterations, as
`OnPolicyRunner.learn` calls them) and `play` (an actor's mean action into
`env.step`, as `scripts.play` does). A workload file names its driver; the
rest of its parameters and the configuration file are data.

Each driver builds the program from the configuration and the seed
(`build`), warms up every shape the window uses and takes what the
reference check needs (`setup`), measures the window (`window`), profiles
a short traced window (`profile`) and hands over its captures (`captures`)
before it frees the program (`free`). Captures live in host memory, so
that they neither raise the device's peak nor outlive the program there.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import random
import time
from pathlib import Path

import torch

from benchmark.lib import tree
from benchmark.lib.tree import host

ROOT = Path(__file__).resolve().parents[2]


def set_path(obj, dotted: str, value) -> None:
  parts = dotted.split('.')
  for p in parts[:-1]:
    obj = getattr(obj, p)
  setattr(obj, parts[-1], value)


def env_cfg(registry, config: dict, traffic: dict, seed: int,
            overrides: dict):
  """The registered env cfg of the configuration's task with the run's
  seed in every field the configuration seeds, then the configuration's,
  the traffic's and the caller's overrides, in that order."""
  cfg = registry.load_cfg(config['task'])
  for path in config.get('seeded', ['seed']):
    set_path(cfg, path, seed)
  for src in (config.get('env_overrides', {}),
              traffic.get('env_overrides', {}), overrides.get('env', {})):
    for k, v in src.items():
      set_path(cfg, k, v)
  return cfg


def sync(device) -> None:
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize()


def check_config(env, config: dict) -> None:
  """The built env holds the configuration as its file states it."""
  s = env.model.stat
  got = {'nq': s.nq, 'nv': s.nv, 'nu': s.nu, 'ngeom': s.ngeom,
         'nbody': s.nbody, 'decimation': env.cfg.decimation,
         'timestep': env.physics_dt, 'iterations': int(s.iterations),
         'integrator': int(s.integrator), 'cone': int(s.cone),
         'action_dim': env.action_dim,
         'observation_dims': dict(env.observation_dims)}
  want = config['model']
  bad = {k: (got[k], v) for k, v in want.items() if got.get(k) != v}
  if bad:
    raise ValueError(f'the built env differs from {config["name"]}: '
                     f'(built, stated) {bad}')


class Driver:
  """What both drivers share: the cell's data, the seed, the device, the
  captures and the traced-run hooks."""

  def __init__(self, cell, seed: int, device='cuda',
               overrides: 'dict | None' = None):
    self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
    self.config, self.traffic = cell.config, cell.traffic
    self.overrides = overrides or {}
    self.rng = random.Random(self.seed)
    self.captures: dict = {'steps': []}
    self.env = None

  @property
  def num_envs(self) -> int:
    return self.env.num_envs

  def stage_hook(self):
    """The env step's own stage hook, as profiler ranges (traced run)."""
    return lambda name: torch.profiler.record_function(f'stage.{name}')

  def capture_pre(self, state, obs=None) -> dict:
    return {'pre': tree.move(state, 'cpu'),
            'gen': self.env.generator.get_state(),
            'obs_in': None if obs is None else tree.move(obs, 'cpu')}

  @staticmethod
  def capture_post(cap: dict, action, out, state, seen: dict) -> dict:
    """The step's outputs, its post-step state, and what `recorded` saw:
    each substep's active contacts (4 of (num_envs, ncon) stacked) and the
    Data after the substeps; all in host memory."""
    obs, reward, terminated, truncated, _ = out
    cap.update(active=host(torch.stack(seen['active'])),
               physics=tree.move(seen['physics'], 'cpu'),
               action=host(action), obs=tree.move(obs, 'cpu'),
               reward=host(reward),
               terminated=host(terminated), truncated=host(truncated),
               qpos=host(state.data.qpos), qvel=host(state.data.qvel))
    return cap

  def capture_start(self, state, obs) -> None:
    self.captures['start'] = {'obs': tree.move(obs, 'cpu'),
                              'model': tree.move(state.model, 'cpu')}

  def free(self) -> None:
    for k in list(vars(self)):
      if k not in ('cell', 'seed', 'device', 'config', 'traffic',
                   'overrides', 'rng', 'captures'):
        setattr(self, k, None)
    gc.collect()
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()


class Train(Driver):
  """PPO from seeded weights: `PPO.learn_iteration` over and over. The
  set-up's first iteration is the one the reference follows: its sampled
  env-steps, its rollout, and the first Adam steps of its update."""

  def build(self) -> None:
    from mjlab_torch.rl.ppo import PPO
    from mjlab_torch.tasks import registry
    task = self.config['task']
    self.env = registry.make(task, cfg=env_cfg(
        registry, self.config, self.traffic, self.seed, self.overrides),
        device=self.device)
    check_config(self.env, self.config)
    self.agent = self.agent_cfg(registry)
    self.ppo = PPO(self.env, self.agent)
    self.ts = self.ppo.init_state(self.seed)
    self.captures['start'] = {
        'obs': tree.move(self.ts.obs, 'cpu'),
        'model': tree.move(self.ts.env_state.model, 'cpu'),
        'params': {k: host(p)
                   for k, p in self.ts.net.named_parameters()}}

  def agent_cfg(self, registry):
    agent = registry.load_cfg(self.config['task'], 'rl_cfg_entry_point')
    agent.seed = self.seed
    for src in (self.config.get('agent_overrides', {}),
                self.traffic.get('agent_overrides', {}),
                self.overrides.get('agent', {})):
      for k, v in src.items():
        set_path(agent, k, v)
    return agent

  @property
  def steps_per_iteration(self) -> int:
    return self.agent.num_steps_per_env

  def setup(self) -> None:
    self.build()
    self.checked_iteration()
    for _ in range(int(self.traffic.get('warmup_iterations', 1))):
      self.ts, logs = self.ppo.learn_iteration(self.ts)
      logs['_clock'].ms()
    sync(self.device)

  def checked_iteration(self) -> None:
    """One learn_iteration through the window's own call, with the
    program's step, GAE, update, loss and Adam step wrapped to copy what
    the reference follows; the wrappers are taken off after it."""
    import mjlab_torch.rl.ppo as ppo_mod
    ppo, cap = self.ppo, self.captures
    chk = self.traffic['check']
    T = self.steps_per_iteration
    at = set(self.rng.sample(range(T), min(int(chk['env_steps']), T)))
    n_adam = int(chk['adam_steps'])
    orig_step, orig_gae = ppo._step_fn, ppo._gae
    orig_update, orig_loss = ppo._update, ppo._loss
    orig_adam = ppo_mod.adam_step_
    calls = {'step': 0, 'adam': 0}
    cap['losses'] = []

    def step(state, action):
      t = calls['step']
      calls['step'] += 1
      if t not in at:
        return orig_step(state, action)
      c = self.capture_pre(state)
      c['t'] = t
      with recorded() as seen:
        state2, out = orig_step(state, action)
      cap['steps'].append(self.capture_post(c, action, out, state2, seen))
      return state2, out

    def gae(traj, last_value):
      cap['traj'] = tree.move(traj, 'cpu')
      return orig_gae(traj, last_value)

    def update(ts, traj, adv, returns):
      cap['update_gen'] = ts.gen.get_state()
      cap['boot_obs'] = tree.move(ts.obs, 'cpu')
      return orig_update(ts, traj, adv, returns)

    def loss(net, mb, old_std):
      out = orig_loss(net, mb, old_std)
      if len(cap['losses']) < n_adam:
        cap['losses'].append(float(out[0].detach()))
      return out

    def adam(params, grads, state, lr):
      orig_adam(params, grads, state, lr)
      calls['adam'] += 1
      if calls['adam'] == 1:
        cap['mu1'] = {k: host(v) for k, v in state.mu.items()}
      if calls['adam'] == n_adam:
        cap['params_n'] = {k: host(p) for k, p in params.items()}

    ppo._step_fn, ppo._gae, ppo._update, ppo._loss = step, gae, update, loss
    ppo_mod.adam_step_ = adam
    try:
      self.ts, logs = ppo.learn_iteration(self.ts)
      logs['_clock'].ms()
    finally:
      ppo._step_fn = orig_step
      for k in ('_gae', '_update', '_loss'):
        vars(ppo).pop(k)
      ppo_mod.adam_step_ = orig_adam
    if calls['adam'] < n_adam or len(cap['steps']) < len(at):
      raise RuntimeError('the checked iteration did not reach the captured '
                         f'steps ({calls})')

  def window(self, seconds: float) -> dict:
    """Whole iterations from a synced boundary until the first boundary at
    or after `seconds`."""
    ppo = self.ppo
    n_env_steps = self.steps_per_iteration * self.env.num_envs
    clocks, nan = [], []
    sync(self.device)
    t0 = time.perf_counter()
    while True:
      self.ts, logs = ppo.learn_iteration(self.ts)
      clocks.append(logs['_clock'].ms())
      nan.append(logs['Episode_Termination/physics_nan'])
      sync(self.device)
      elapsed = time.perf_counter() - t0
      if elapsed >= seconds:
        break
    self.clocks = clocks
    iters = len(clocks)
    failed = int(sum(float(x) for x in nan))
    print(f'window: {iters} iterations of {n_env_steps} env-steps in '
          f'{elapsed:.3f} s', flush=True)
    return {'attempted': iters * n_env_steps, 'failed': failed,
            'values': {'train_env_steps_per_s': iters * n_env_steps / elapsed},
            'elapsed': elapsed}

  def profiled(self, hooks) -> dict:
    """One learn_iteration with the step's stages and the rollout and
    update as ranges; returns what the readers need besides the trace."""
    ppo = self.ppo
    orig_step, orig_rollout, orig_update = ppo._step_fn, ppo._rollout, \
        ppo._update
    staged = functools.partial(self.env._step_fn, stage=self.stage_hook())

    def step(state, action):
      with torch.profiler.record_function('bench.env_step'):
        return staged(state, action)

    def rollout(ts):
      with torch.profiler.record_function('bench.rollout'):
        return orig_rollout(ts)

    def update(*a):
      with torch.profiler.record_function('bench.update'):
        return orig_update(*a)

    ppo._step_fn, ppo._rollout, ppo._update = step, rollout, update
    try:
      with hooks():
        self.ts, logs = ppo.learn_iteration(self.ts)
        logs['_clock'].ms()
        sync(self.device)
    finally:
      ppo._step_fn = orig_step
      vars(ppo).pop('_rollout', None)
      vars(ppo).pop('_update', None)
    alg = self.agent.algorithm
    return {'steps': self.steps_per_iteration,
            'mlp': {'actor': _dims(self.ts.net.actor),
                    'critic': _dims(self.ts.net.critic)},
            'update_passes': alg.num_learning_epochs,
            'clock': self.clocks}


class Play(Driver):
  """The shipped actor's mean action into `env.step`, no learning. The
  reference follows env-steps of the window sampled from the seed."""

  def build(self) -> None:
    from mjlab_torch.rl.networks import load_actor
    from mjlab_torch.tasks import registry
    self.env = registry.make(self.config['task'], cfg=env_cfg(
        registry, self.config, self.traffic, self.seed, self.overrides),
        device=self.device)
    check_config(self.env, self.config)
    self.actor = load_actor(ROOT / self.traffic['actor'], device=self.device)
    self.obs, _ = self.env.reset(self.seed)
    self.capture_start(self.env.state, self.obs)

  def step(self):
    action = self.actor(self.obs)
    self.obs, rew, term, trunc, extras = self.env.step(action)
    return action, (self.obs, rew, term, trunc, extras)

  def setup(self) -> None:
    self.build()
    for _ in range(int(self.traffic['warmup_steps'])):
      self.step()
    sync(self.device)

  def window(self, seconds: float) -> dict:
    """Env-steps until `seconds` have passed, each timed on the host from
    the actor's call to the step's own sync, `bool(done.any())`. A step
    the check samples copies its state before the timer starts and its
    outputs after it stops; its substeps also keep their active contacts
    on the device (one comparison a substep) and a device copy of the Data
    after its substeps."""
    chk = self.traffic['check']
    at = set(self.rng.sample(range(int(chk['within_steps'])),
                             int(chk['env_steps'])))
    times, nan = [], []
    sync(self.device)
    t0 = time.perf_counter()
    i = 0
    while True:
      c = self.capture_pre(self.env.state, self.obs) if i in at else None
      with recorded() if c else _nothing() as seen:
        a = time.perf_counter()
        action, out = self.step()
        bool((out[2] | out[3]).any())
        times.append(time.perf_counter() - a)
      nan.append(out[4]['Episode_Termination/physics_nan'])
      if c is not None:
        c['t'] = i
        self.captures['steps'].append(
            self.capture_post(c, action, out, self.env.state, seen))
      i += 1
      elapsed = time.perf_counter() - t0
      if elapsed >= seconds:
        break
    sync(self.device)
    elapsed = time.perf_counter() - t0
    # every step whose capture fell after the window's end is due anyway
    while len(self.captures['steps']) < len(at) and i <= max(at):
      c = self.capture_pre(self.env.state, self.obs) if i in at else None
      with recorded() if c else _nothing() as seen:
        action, out = self.step()
      if c is not None:
        c['t'] = i
        self.captures['steps'].append(
            self.capture_post(c, action, out, self.env.state, seen))
      i += 1
    failed = int(torch.stack(nan).sum())
    ms = sorted(t * 1e3 for t in times)
    p95 = _quantile(ms, 0.95)
    n = len(ms)
    print(f'window: {n} env-steps of {self.env.num_envs} envs in '
          f'{elapsed:.3f} s; step ms median {_quantile(ms, 0.5):.3f}, p95 '
          f'{p95:.3f} over {n} samples ({n - int(0.95 * n)} beyond it)',
          flush=True)
    return {'attempted': n * self.env.num_envs, 'failed': failed,
            'values': {'play_env_steps_per_s': n * self.env.num_envs / elapsed,
                       'play_step_ms_p95': p95},
            'elapsed': elapsed}

  def profiled(self, hooks) -> dict:
    staged = functools.partial(self.env._step_fn, stage=self.stage_hook())
    env = self.env

    def step_fn(state, action):
      with torch.profiler.record_function('bench.env_step'):
        return staged(state, action)

    actor = self.actor
    env._step_fn = step_fn
    n = int(self.traffic['profile_steps'])
    try:
      with hooks():
        for _ in range(n):
          with torch.profiler.record_function('bench.actor'):
            action = actor(self.obs)
          self.obs, _, term, trunc, _ = env.step(action)
          bool((term | trunc).any())
        sync(self.device)
    finally:
      vars(env).pop('_step_fn', None)
    return {'steps': n, 'mlp': {'actor': _dims(actor.actor)},
            'update_passes': 0, 'clock': []}


@contextlib.contextmanager
def recorded():
  """While the block runs (one env-step of the port), `seen['active']`
  gathers each substep's active contacts and `seen['physics']` a device
  copy of the Data after the substeps (what the env's `sanitize` returns),
  all on the device, with no host read."""
  import mjlab_torch.envs.manager_based_rl_env as env_mod
  from mjlab_torch.physics import pipeline
  seen = {}
  orig = env_mod.sanitize

  def sanitize(data):
    out = orig(data)
    seen['physics'] = tree.move(out, None)
    return out

  env_mod.sanitize = sanitize
  try:
    with tree.contacts_recorded(pipeline, []) as active:
      seen['active'] = active
      yield seen
  finally:
    env_mod.sanitize = orig


@contextlib.contextmanager
def _nothing():
  yield None


def _dims(mlp) -> list:
  return [(layer.in_features, layer.out_features) for layer in mlp.layers]


def _quantile(sorted_vals: list, q: float) -> float:
  """The q-quantile of sorted values, by linear interpolation between the
  order statistics (numpy's default)."""
  n = len(sorted_vals)
  pos = q * (n - 1)
  lo = int(pos)
  hi = min(lo + 1, n - 1)
  return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


DRIVERS = {'train': Train, 'play': Play}
