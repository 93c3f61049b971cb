"""The comparison that decides `correct`: the program's captures against
the frozen plain reference (benchmark/reference/mjref), run once the window
has closed and the program is freed.

The reference builds its own env (and, training, its own learner) from the
configuration and the seed: its own Model from the raw snapshot, its own
terrain from the seeded generator, its own initial weights from the
learner's seeded generator. That start is compared with the program's.
An env-step of the program cannot be reproduced from the seed alone (the
dynamics are chaotic), so the reference follows each captured env-step
from the program's own state before it: that state is rebuilt in the
reference's classes, with the reference's own Model, and its generator is
set to the program's, so that resets, pushes, commands and noise draw the
same numbers. Each captured env-step is judged in two stages: the physics
(the reference's own substeps against the program's, from one state) and
the managers (the reference's terminations, rewards, resets, commands,
events and observations run on the program's own post-substep Data, so
that the chaos of the contacts stays out of them). Training also follows
the captured rollout: the reference recomputes the old policy's means,
values and log-probabilities from the stored observations and actions,
then GAE and the first Adam steps of the update from its own initial
weights, the minibatches drawn from the learner generator's state there.

`Reference.outputs` gives the compared quantities of one side in the
layout of `program_outputs`; `readings(side, ref, managed)` gives the
numbers compared. A variant of the reference stands in for the program to
read the control (`tf32`: every float32 product in TF32) and three faults
(`half_batch`: each minibatch's loss over its first half;
`altered_answer`: env 0's observation, reward and next state moved by
0.01 where they are produced; `few_envs`: the physics' answer, the
velocities after the substeps, 1 % off in one env of every 32).

The raw files that the reference reads (the compiled scene's snapshot, the
shipped actor) are copies under benchmark/reference/data, pinned by their
sha256 in the configuration and traffic files: a changed copy fails the
run before the reference is built.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import statistics
from pathlib import Path

import torch

from benchmark.lib import tree
from benchmark.lib.tree import host
from benchmark.lib.drivers import env_cfg, set_path

ROOT = Path(__file__).resolve().parents[2]
ADAM_B1 = 0.9
ALTER = 0.01  # the `altered_answer` fault's change of an answer
FEW = 32  # the `few_envs` fault moves one env in FEW
QUIET_GRAD = 1e-3  # a leaf whose reference gradient norm is under this
# share of the median leaf's moves by round-off alone: left out of `change`


class _Stop(Exception):
  pass


@contextlib.contextmanager
def precision(variant: 'str | None'):
  """float32 as the configuration states it (no TF32), or TF32 for the
  `tf32` control."""
  m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
  tf32 = variant == 'tf32'
  torch.backends.cuda.matmul.allow_tf32 = tf32
  torch.backends.cudnn.allow_tf32 = tf32
  try:
    yield
  finally:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


# ---------------------------------------------------------------------------
# the program's side, from its captures

STEP_KEYS = ('active', 'physics', 'action', 'obs', 'reward', 'terminated',
             'truncated', 'qpos', 'qvel')


def program_outputs(captures: dict) -> dict:
  out = {'start': captures['start'],
         'steps': [{k: c[k] for k in STEP_KEYS if k in c}
                   for c in captures['steps']]}
  traj = captures.get('traj')
  if traj is not None:
    out['forward'] = {'mean': traj.mean, 'value': traj.value,
                      'logprob': traj.logprob}
    out['update'] = {'losses': captures['losses'], 'mu1': captures['mu1'],
                     'params_n': captures['params_n'],
                     'params0': captures['start']['params']}
  return out


# ---------------------------------------------------------------------------
# the reference's side


def verify_pinned(*sources: dict) -> None:
  """Every file that a configuration or traffic file pins (`pinned`:
  {path from the repo root: sha256}) has that digest."""
  for src in sources:
    for rel, want in src.get('pinned', {}).items():
      got = hashlib.sha256((ROOT / rel).read_bytes()).hexdigest()
      if got != want:
        raise ValueError(f'{rel} has sha256 {got}; pinned: {want}')


class Reference:
  """The frozen reference's env (and learner, or actor) for one run,
  built from the configuration and the seed."""

  def __init__(self, cell, seed: int, device, overrides: 'dict | None'):
    from mjref.tasks import registry
    overrides = overrides or {}
    self.cell, self.seed = cell, seed
    self.device = torch.device(device)
    config, traffic = cell.config, cell.traffic
    verify_pinned(config, traffic)
    self.n_adam = int(traffic['check'].get('adam_steps', 0))
    with precision(None), torch.no_grad():
      self.env = registry.make(config['task'], cfg=env_cfg(
          registry, config, traffic, seed, overrides), device=self.device)
      self.train = traffic['driver'] == 'train'
      if self.train:
        from mjref.rl.ppo import PPO
        agent = registry.load_cfg(config['task'], 'rl_cfg_entry_point')
        agent.seed = seed
        for src in (config.get('agent_overrides', {}),
                    traffic.get('agent_overrides', {}),
                    overrides.get('agent', {})):
          for k, v in src.items():
            set_path(agent, k, v)
        self.ppo = PPO(self.env, agent)
        ts = self.ppo.init_state(seed)
        state0, obs0 = ts.env_state, ts.obs
        params = {k: host(p) for k, p in ts.net.named_parameters()}
      else:
        from mjref.rl.networks import load_actor
        obs0, _ = self.env.reset(seed)
        state0, params = self.env.state, None
        self.actor = load_actor(ROOT / traffic['actor'], device=self.device)
      self.model = state0.model
      self.start = {'obs': tree.move(obs0, 'cpu'),
                    'model': tree.move(state0.model, 'cpu')}
      if params is not None:
        self.start['params'] = params

  def step(self, c: dict, variant: 'str | None' = None,
           physics=None) -> dict:
    """The reference's env-step from the captured pre-step state, action
    and generator state. With `physics` (a post-physics Data), the
    managers' part of the step runs on it in place of the reference's own
    substeps' result."""
    import mjref.envs.manager_based_rl_env as env_mod
    from mjref.physics import pipeline
    env = self.env
    got = {}
    orig = env_mod.sanitize

    def sanitize(data):
      out = orig(data)
      if variant == 'few_envs':
        # the substeps' velocities 1 % off in one env of every FEW
        qvel = out.qvel.clone()
        qvel[::FEW] *= 1 + ALTER
        out = out.replace(qvel=qvel)
      got['physics'] = tree.move(out, 'cpu')
      if physics is None:
        return out
      return tree.rebuild(physics, 'mjref', self.device)

    with precision(variant), torch.no_grad():
      state = tree.rebuild(dataclasses.replace(c['pre'], model=None),
                           'mjref', self.device).replace(model=self.model)
      env.generator.set_state(c['gen'])
      s = {}
      if not self.train:
        s['action'] = host(self.actor(tree.move(c['obs_in'], self.device)))
      env_mod.sanitize = sanitize
      try:
        with tree.contacts_recorded(pipeline, []) as active:
          state2, (obs, reward, term, trunc, _) = env.step_fn(
              state, c['action'].to(self.device))
      finally:
        env_mod.sanitize = orig
      s.update(active=host(torch.stack(active)), physics=got['physics'],
               obs=tree.move(obs, 'cpu'), reward=host(reward),
               terminated=host(term), truncated=host(trunc),
               qpos=host(state2.data.qpos), qvel=host(state2.data.qvel))
    if variant == 'altered_answer':
      # env 0's answers moved where they are produced: an observation, the
      # reward and the next state
      next(iter(s['obs'].values()))[0, 0] += ALTER
      s['reward'][0] += ALTER
      s['qpos'][0, 0] += ALTER
    return s

  def outputs(self, captures: dict, variant: 'str | None' = None) -> dict:
    """The reference under `variant`: its own start, env-steps (each with
    its own physics) and learner, in program_outputs' layout. With no
    variant, what every side is judged against; with one, a side put in
    the program's place."""
    out = {'start': self.start,
           'steps': [self.step(c, variant) for c in captures['steps']]}
    if self.train:
      out.update(self.learner(captures, variant))
    return out

  def managed(self, captures: dict, side: dict) -> list:
    """The reference's managers on `side`'s physics, each env-step."""
    return [self.step(c, physics=s['physics'])
            for c, s in zip(captures['steps'], side['steps'])]

  def learner(self, captures: dict, variant: 'str | None' = None) -> dict:
    """The old policy's forward over the captured rollout, then GAE and
    the first `n_adam` Adam steps of the update, from the reference's own
    initial learner (made anew, so that every call starts alike)."""
    import mjref.rl.ppo as ppo_mod
    from mjref.rl.networks import gaussian_logprob
    ppo, device, n_adam = self.ppo, self.device, self.n_adam
    with precision(variant):
      with torch.no_grad():
        ts = ppo.init_state(self.seed)
        traj = tree.rebuild(captures['traj'], 'mjref', device)
        mean, std, value = ts.net(traj.actor_obs, traj.critic_obs)
        logprob = gaussian_logprob(mean, std, traj.action)
        value = value.reshape(traj.value.shape)
        forward = {'mean': host(mean), 'value': host(value),
                   'logprob': host(logprob)}
        traj = dataclasses.replace(traj, mean=mean, value=value,
                                   logprob=logprob)
        boot = tree.move(captures['boot_obs'], device)
        last_value = ppo._policy(ts, boot)[-1]
        adv, returns = ppo._gae(traj, last_value)
      params0 = {k: host(p) for k, p in ts.net.named_parameters()}
      ts.gen.set_state(captures['update_gen'])
      losses, got = [], {}
      orig_loss, orig_adam = ppo._loss, ppo_mod.adam_step_

      def loss(net, mb, old_std):
        if variant == 'half_batch':
          mb = tuple(x[:x.shape[0] // 2] for x in mb)
        out = orig_loss(net, mb, old_std)
        losses.append(float(out[0].detach()))
        return out

      def adam(params, grads, state, lr):
        orig_adam(params, grads, state, lr)
        k = int(state.count)
        if k == 1:
          got['mu1'] = {n: host(v) for n, v in state.mu.items()}
        if k == n_adam:
          got['params_n'] = {n: host(p) for n, p in params.items()}
          raise _Stop

      ppo._loss = loss
      ppo_mod.adam_step_ = adam
      try:
        ppo._update(ts, traj, adv.clone(), returns.clone())
      except _Stop:
        pass
      finally:
        vars(ppo).pop('_loss')
        ppo_mod.adam_step_ = orig_adam
    return {'forward': forward,
            'update': {'losses': losses[:n_adam], 'mu1': got['mu1'],
                       'params_n': got['params_n'], 'params0': params0}}


# ---------------------------------------------------------------------------
# the numbers compared


def env_gap(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
  """(N,) per row: the largest |p - r| over the row, over 1 + the largest
  |r| of the row; NaN against a number is infinite, NaN against NaN 0."""
  p = (p.flatten(1) if p.dim() > 1 else p[:, None]).double()
  r = (r.flatten(1) if r.dim() > 1 else r[:, None]).double()
  d = (p - r).abs()
  d = torch.where(p.isnan() & r.isnan(), torch.zeros_like(d), d)
  d = torch.nan_to_num(d, nan=float('inf'))
  scale = 1.0 + torch.nan_to_num(r.abs(), nan=0.0).amax(1)
  return d.amax(1) / scale


def _stats(name: str, g: torch.Tensor, out: dict) -> None:
  g = g.flatten().double()
  if not len(g):  # every env flipped: flip.share says so
    g = torch.zeros(1, dtype=torch.float64)
  out[f'{name}.max'] = float(g.max())
  out[f'{name}.p50'] = float(g.median())


def _tree_gap(p, r) -> float:
  """Largest |p - r| over 1 + largest |r| over every tensor of two trees
  of one layout."""
  ps, rs = [], []

  def walk(a, b):
    if isinstance(a, torch.Tensor):
      ps.append(a)
      rs.append(b)
    elif dataclasses.is_dataclass(a):
      for f in dataclasses.fields(a):
        walk(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
      for k in a:
        walk(a[k], b[k])
  walk(p, r)
  worst = 0.0
  for a, b in zip(ps, rs):
    if a.numel() == 0 or not a.is_floating_point():
      if not torch.equal(a, b):
        return float('inf')
      continue
    a, b = a.double().flatten(), b.double().flatten()
    worst = max(worst, float(env_gap(a[None], b[None])[0]))
  return worst


def _leaf_norm_gap(p: dict, r: dict, keep=None) -> float:
  """The worst leaf's |‖p‖ - ‖r‖| over the larger of its reference norm
  and the median leaf's reference norm."""
  names = [k for k in r if keep is None or keep[k]]
  rn = {k: float(r[k].double().norm()) for k in r}
  med = statistics.median(rn.values())
  return max(abs(float(p[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
             for k in names)


def readings(side: dict, ref: dict, managed: list) -> dict:
  """The compared numbers of `side` (the program, or a variant of the
  reference in its place) against the reference: `ref` its own outputs,
  `managed` its managers run on `side`'s physics."""
  out = {}
  s, r = side['start'], ref['start']
  # the Model from the raw snapshot and the initial weights from the seeded
  # generator are exact: any difference is a fault
  out['start.exact'] = max(_tree_gap(s['model'], r['model']),
                           _tree_gap(s.get('params', {}), r.get('params', {})))
  # the first observations (the reset's forward pass, K3 among it) join
  # the managers' observations
  obs = [torch.stack([env_gap(s['obs'][g], r['obs'][g])
                      for g in r['obs']]).amax(0)]
  action, physics, flips, reward, state, flags = [], [], [], [], [], []
  for a, b, m in zip(side['steps'], ref['steps'], managed):
    if 'action' in b:
      action.append(env_gap(a['action'], b['action']))
    # physics: the substeps from one state, on both sides; chaotic where a
    # contact or a constraint row lies within rounding of its threshold
    pa, pb = a['physics'], b['physics']
    physics.append(torch.maximum(env_gap(pa.qpos, pb.qpos),
                                 env_gap(pa.qvel, pb.qvel)))
    flips.append((a['active'] != b['active']).flatten(2).any(-1).any(0)
                 .double())
    # managers: the reference's on the side's own physics, exact but for
    # rounding
    obs.append(torch.stack([env_gap(a['obs'][g], m['obs'][g])
                            for g in m['obs']]).amax(0))
    reward.append(env_gap(a['reward'], m['reward']))
    state.append(torch.maximum(env_gap(a['qpos'], m['qpos']),
                               env_gap(a['qvel'], m['qvel'])))
    flags.append(((a['terminated'] != m['terminated'])
                  | (a['truncated'] != m['truncated'])).double())
  if action:
    _stats('action', torch.cat(action), out)
  g = torch.cat(physics)
  _stats('physics', g, out)
  for q in (0.75, 0.9):
    out[f'physics.p{int(q * 100)}'] = float(torch.quantile(g, q))
  out['physics.share_over_1e-3'] = float((g > 1e-3).double().mean())
  out['physics.flip_share'] = float(torch.cat(flips).mean())
  for name, v in (('obs', obs), ('reward', reward), ('state', state)):
    _stats(name, torch.cat(v), out)
  out['flags.share'] = float(torch.cat(flags).mean())
  if 'forward' in ref:
    f, g = side['forward'], ref['forward']
    rows = lambda x: x.reshape(-1, x.shape[-1]) if x.dim() > 2 else \
        x.reshape(-1, 1)
    fwd = torch.maximum(env_gap(rows(f['mean']), rows(g['mean'])),
                        env_gap(rows(f['value']), rows(g['value'])))
    fwd = torch.maximum(fwd, env_gap(rows(f['logprob']), rows(g['logprob'])))
    _stats('forward', fwd, out)
    u, v = side['update'], ref['update']
    out['loss.max'] = max(abs(a - b) / max(abs(b), 1e-30)
                          for a, b in zip(u['losses'], v['losses']))
    g_side = {k: t / (1 - ADAM_B1) for k, t in u['mu1'].items()}
    g_ref = {k: t / (1 - ADAM_B1) for k, t in v['mu1'].items()}
    out['grad1.max'] = _leaf_norm_gap(g_side, g_ref)
    gn = {k: float(t.double().norm()) for k, t in g_ref.items()}
    med = statistics.median(gn.values())
    keep = {k: gn[k] >= QUIET_GRAD * med for k in gn}
    out['change.max'] = _leaf_norm_gap(
        {k: u['params_n'][k] - u['params0'][k] for k in u['params_n']},
        {k: v['params_n'][k] - v['params0'][k] for k in v['params_n']}, keep)
    out['change.left_out'] = float(sum(not x for x in keep.values()))
  return out


def judge(values: dict, limits: dict) -> 'tuple[bool, dict]':
  """(every compared number within its limit, {name: {value, limit}}) for
  the numbers that have a limit; a missing or non-finite number fails."""
  checks, ok = {}, True
  for name, limit in limits.items():
    v = values.get(name)
    good = v is not None and v == v and v <= limit
    ok &= good
    checks[name] = {'value': v, 'limit': limit}
  return ok, checks
