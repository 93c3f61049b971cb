"""Manager-based RL environment on the batched PyTorch engine.

Counterpart of mjlab_tpu/envs/manager_based_rl_env.py. The RL step
(decimation physics loop, reward, termination, masked resets, command and
event updates, observation pipeline) is a function from an EnvState to a
new EnvState. Resets are masked full-batch updates: nothing in `step`
indexes by a mask, gathers the ids of the envs that are done, or branches on
a tensor's value, with one exception, the conditional refresh below.

Step order: decimation loop -> episode_length++ -> terminations -> rewards
-> masked reset -> forward refresh (if any env reset) -> command compute ->
interval events -> observations.

The refresh after a reset recomputes the derived physics data of every env
when at least one env reset, and of none otherwise, as the reference does
(`lax.cond(any(done), forward, identity)`). Deciding that takes the step's
one read of a device value on the host, `bool(done.any())`.

Random draws come from one `torch.Generator` on the env's device, seeded
from `cfg.seed` and handed to every manager.

Sharded (parallel/sharding.py, `world`): the env is one rank's rows of the
global env of `cfg.scene.num_envs` envs; `num_envs` is the rank's count.
Its origins and terrain levels are the global env's rows, its generator
draws the whole env axis and keeps its rows (utils/math.py:
ShardedGenerator), so env i steps as in one process, and the refresh after
a reset follows any reset of any rank (one all-reduce of the flag before
the step's read).

Physics blowups: an env whose state goes non-finite (or past
`sanity_qvel_limit`) is terminated, reset and its Data sanitized within the
step. Two debugging aids see the state before `sanitize` does:
- a NanGuard (utils/nan_guard.py) attached as `nan_guard` for the length of
  a guarded call is handed the post-substep state and its non-finite mask;
  its flag joins the step's one host read;
- with `MJLAB_BLOWUP_DUMP=<dir>` the step writes the pre-substep state of
  up to `min(8, num_envs)` blown-up envs into a device ring in
  `EnvState.forensic` (`MJLAB_BLOWUP_DUMP_MAX` slots, default 40), with no
  host read; `maybe_dump_forensics` fetches it into `<dir>/blowup_ring.npz`
  for scripts/blowup_replay.py (a sharded env's rank writes
  `blowup_ring_rank<r>.npz`, with global env ids).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

import numpy as np
import torch

from mjlab_torch.envs.types import EnvCtx, EnvState
from mjlab_torch.managers.command_manager import CommandManager
from mjlab_torch.managers.managers import (
    ActionManager,
    CurriculumManager,
    EventManager,
    ObservationManager,
    RewardManager,
    TerminationManager,
)
from mjlab_torch.parallel.sharding import World, all_reduce_flat
from mjlab_torch.physics import pipeline as phys_pipeline
from mjlab_torch.physics.types import Data
from mjlab_torch.scene.scene import Scene, SceneCfg
from mjlab_torch.sim.sim import (
    SimulationCfg,
    expand_model_fields,
    make_batched_data,
)
from mjlab_torch.utils import tracing
from mjlab_torch.utils.math import ShardedGenerator


@dataclasses.dataclass
class ManagerBasedRlEnvCfg:
  scene: SceneCfg = None
  sim: SimulationCfg = dataclasses.field(default_factory=SimulationCfg)
  decimation: int = 4
  episode_length_s: float = 20.0
  seed: int = 42
  # Physics sanity guard: envs whose max |qvel| exceeds this are treated
  # like NaN blowups (force-terminate, masked reset, zero reward this
  # step). float32 contact solves can produce finite-but-exploding states
  # for several steps before the first inf or NaN; 100 is still 3-5x above
  # any legitimate humanoid joint or root velocity including impact jitter
  # (walking peaks are under 30 rad/s), so healthy dynamics never trip it.
  sanity_qvel_limit: float = 100.0
  actions: Any = None
  observations: Any = None
  rewards: Any = None
  terminations: Any = None
  events: Any = None
  commands: Any = None
  curriculum: Any = None


# the env step's default stage hook: the span env.<stage>
_STAGE = tracing.stages('env.')


def sanitize(data: Data) -> Data:
  """Data with every non-finite float replaced by zero (new tensors)."""
  fix = lambda a: (torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)
                   if a.is_floating_point() else a)
  contact = data.contact.replace(**{
      f.name: fix(getattr(data.contact, f.name))
      for f in dataclasses.fields(data.contact)})
  return data.replace(contact=contact, **{
      f.name: fix(getattr(data, f.name))
      for f in dataclasses.fields(data) if f.name != 'contact'})


class ManagerBasedRlEnv:
  """Vectorized RL env with a functional core (`init_state`, `step_fn`)
  and a stateful gym-like API (`reset`, `step`).

  device: 'cuda' unless the caller asks for 'cpu'; asking for CUDA on a
  host without a GPU raises. mj_model: the compiled scene (a
  mujoco.MjModel or a ModelArrays); None takes it by the scene's route
  rule (scene/scene.py: the snapshot of `cfg.scene.model_fn` when it
  records the cfg's spec inputs, else the scene composed from the cfgs).
  world: this rank's parallel.sharding.World (its device is the env's);
  None is one process holding every env."""

  def __init__(self, cfg: ManagerBasedRlEnvCfg, device='cuda',
               dtype=torch.float32, mj_model=None,
               world: 'World | None' = None):
    self.cfg = cfg
    if world is not None and world.num_envs != cfg.scene.num_envs:
      raise ValueError(f'the world holds {world.num_envs} envs, the cfg '
                       f'{cfg.scene.num_envs}')

    # --- scene + model ---
    self.scene = Scene(cfg.scene, mj_model=mj_model, device=device,
                       dtype=dtype,
                       env_rows=None if world is None else world.rows)
    self.device = self.scene.device
    self.world = world or World(num_envs=cfg.scene.num_envs,
                                device=self.device)
    self.num_envs = self.world.n_local
    # the solver and integrator options of the cfg: into the spec of a
    # scene composed from its cfgs, into the compiled model of a snapshot
    self.scene.apply_options(cfg.sim.mujoco)
    base_model = self.scene.initialize(ncon_cap=cfg.sim.nconmax)
    self.physics_dt = cfg.sim.mujoco.timestep
    self.step_dt = cfg.decimation * self.physics_dt
    self.max_episode_length = int(
        math.ceil(cfg.episode_length_s / self.step_dt))

    # --- managers ---
    n, dev = self.num_envs, self.device
    self.event_manager = EventManager(cfg.events, self.scene, n,
                                      self.step_dt)
    # model fields that carry a leading env axis (domain randomization)
    self.per_env_fields = sorted(
        set(self.event_manager.domain_randomization_fields()))
    model = expand_model_fields(base_model, self.per_env_fields, n)
    self.command_manager = CommandManager(cfg.commands, self.scene, n)
    self.action_manager = ActionManager(cfg.actions, self.scene, n)
    self.reward_manager = RewardManager(cfg.rewards, self.scene)
    self.termination_manager = TerminationManager(cfg.terminations,
                                                  self.scene)
    self.curriculum_manager = CurriculumManager(cfg.curriculum, self.scene)
    # the terrain-level curriculum carries per-env spawn origins in its state
    self._origin_term = self.curriculum_manager.origin_term()

    # --- template state (also used to measure observation widths) ---
    w = self.world
    self._gen = (ShardedGenerator(dev, (w.offset, n, w.num_envs))
                 if w.sharded else torch.Generator(device=dev))
    self._gen.manual_seed(cfg.seed)
    data = make_batched_data(base_model, n, device=dev)
    model, data = self.event_manager.apply_startup(model, data, self._gen)
    self.model = model
    zeros = lambda *shape, dtype=dtype: torch.zeros(shape, dtype=dtype,
                                                    device=dev)
    adim = self.action_manager.total_dim
    template = EnvState(
        model=model, data=data,
        episode_length=zeros(n, dtype=torch.int32),
        common_step=zeros(dtype=torch.int32),
        actions=zeros(n, adim), prev_actions=zeros(n, adim),
        command=self.command_manager.init_state(self._gen), obs={},
        event=self.event_manager.init_state(self._gen, dtype, dev),
        reward_sums=zeros(n, max(len(self.reward_manager.terms), 1)),
        curriculum=self.curriculum_manager.init_state(),
        reward=self.reward_manager.init_state(n, dtype, dev))

    def probe(func, params):
      return func(self._make_ctx(template), **params).shape

    self.observation_manager = ObservationManager(
        cfg.observations, self.scene, n, probe)
    self._template_state = template.replace(
        obs=self.observation_manager.init_state(dtype, dev))
    self._state: 'EnvState | None' = None
    self.last_extras: dict = {}
    # a NanGuard, only while a guarded call of the step runs
    self.nan_guard = None

    # --- physics-blowup forensic ring (off unless MJLAB_BLOWUP_DUMP) ---
    self._blowup_dump_dir = os.environ.get('MJLAB_BLOWUP_DUMP') or None
    self._blowup_count = 0  # host side: ring captures persisted so far
    self._forensic_cap = int(os.environ.get('MJLAB_BLOWUP_DUMP_MAX', 40))
    self._forensic_k = min(8, n)  # captures per control step
    # the per-env model fields, in the Model's field order
    self._batched_model_fields = [f.name for f in dataclasses.fields(model)
                                  if f.name in self.per_env_fields]
    if self._blowup_dump_dir:
      self._template_state = self._template_state.replace(
          forensic=self._forensic_ring(data, model))

  # ------------------------------------------------------------------
  # physics-blowup forensics
  # ------------------------------------------------------------------
  def _forensic_ring(self, data: Data, model) -> dict:
    """An empty ring: `cap` slots of the pre-substep state an env had
    before its step blew up. dtypes as the JAX package's ring: the data's,
    but `processed_action` takes the default float dtype."""
    cap, dev = self._forensic_cap, self.device

    def slots(x, dtype=None):
      return torch.zeros((cap,) + tuple(x.shape[1:]),
                         dtype=dtype or x.dtype, device=dev)

    i32 = torch.int32
    ring = {
        'count': torch.zeros((), dtype=i32, device=dev),
        'total_bad': torch.zeros((), dtype=i32, device=dev),
        'env_id': torch.full((cap,), -1, dtype=i32, device=dev),
        'episode_length': torch.zeros(cap, dtype=i32, device=dev),
        'time': slots(data.time),
        'qpos': slots(data.qpos),
        'qvel': slots(data.qvel),
        'ctrl': slots(data.ctrl),
        'qacc_warmstart': slots(data.qacc_warmstart),
        'xfrc_applied': slots(data.xfrc_applied),
        'qfrc_applied': slots(data.qfrc_applied),
        'processed_action': torch.zeros(
            (cap, self.action_manager.total_dim),
            dtype=torch.get_default_dtype(), device=dev),
        'qvel_peaks': torch.zeros((cap, self.cfg.decimation),
                                  dtype=data.qvel.dtype, device=dev),
    }
    for f in self._batched_model_fields:
      ring[f'model_{f}'] = slots(getattr(model, f))
    return ring

  def _forensic_write(self, ring: dict, bad: torch.Tensor, pre: Data,
                      processed: torch.Tensor, state: EnvState,
                      qvel_peaks: torch.Tensor) -> dict:
    """The ring with the pre-step snapshots of the first `k` envs of
    `bad` written into its next slots (newest wins, modulo the ring), as
    new tensors. No host read: the ids are ranked by a cumsum, and writes
    of unused ids go to a spare row that is cut off. qvel_peaks:
    (decimation, N)."""
    cap, k = self._forensic_cap, self._forensic_k
    n, dev = bad.shape[0], bad.device
    # the first k ids of `bad`, -1 after the last (jnp.nonzero with size=k)
    rank = bad.cumsum(0) - 1
    ids = torch.full((k + 1,), -1, dtype=torch.long, device=dev)
    ids.scatter_(0, torch.where(bad & (rank < k), rank, k),
                 torch.arange(n, device=dev))
    ids = ids[:k]
    valid = ids >= 0
    slots = torch.where(valid, (ring['count'] + valid.cumsum(0) - 1) % cap,
                        cap)
    safe = ids.clamp_min(0)
    vals = {
        'env_id': ids,
        'episode_length': state.episode_length[safe],
        'time': pre.time[safe],
        'qpos': pre.qpos[safe],
        'qvel': pre.qvel[safe],
        'ctrl': pre.ctrl[safe],
        'qacc_warmstart': pre.qacc_warmstart[safe],
        'xfrc_applied': pre.xfrc_applied[safe],
        'qfrc_applied': pre.qfrc_applied[safe],
        'processed_action': processed[safe],
        'qvel_peaks': qvel_peaks[:, safe].T,
    }
    for f in self._batched_model_fields:
      vals[f'model_{f}'] = getattr(state.model, f)[safe]

    def put(buf, v):
      spare = torch.cat((buf, buf[:1]))
      return spare.index_copy_(0, slots, v.to(buf.dtype))[:cap]

    new = {key: put(ring[key], v) for key, v in vals.items()}
    new['count'] = ring['count'] + valid.sum(dtype=torch.int32)
    new['total_bad'] = ring['total_bad'] + bad.sum(dtype=torch.int32)
    return new

  def maybe_dump_forensics(self, state: 'EnvState | None' = None) -> int:
    """Host side: fetch the ring and write what it holds to
    `<MJLAB_BLOWUP_DUMP>/blowup_ring.npz` (the JAX package's layout, read
    by scripts/blowup_replay.py). Does nothing when the ring is off or
    holds nothing new. Returns the total captured count."""
    state = state if state is not None else self._state
    if not self._blowup_dump_dir or state is None or not state.forensic:
      return 0
    count = int(state.forensic['count'])
    if count <= self._blowup_count:
      return count
    self._blowup_count = count
    # in sorted key order, as jax.device_get returns the JAX package's ring
    ring = {k: state.forensic[k].cpu().numpy()
            for k in sorted(state.forensic)}
    os.makedirs(self._blowup_dump_dir, exist_ok=True)
    keep = ring['env_id'] >= 0
    payload = {k: v[keep] for k, v in ring.items()
               if k not in ('count', 'total_bad')}
    # global env ids: a sharded env's rank holds rows from its offset
    payload['env_ids'] = payload.pop('env_id') + self.world.offset
    # the replay reads (decimation, n), as the step computes them
    payload['qvel_peaks'] = payload['qvel_peaks'].T
    payload['n_bad_total'] = int(ring['total_bad'])
    payload['model_field_names'] = np.array(self._batched_model_fields)
    name = ('blowup_ring.npz' if not self.world.sharded
            else f'blowup_ring_rank{self.world.rank}.npz')
    path = os.path.join(self._blowup_dump_dir, name)
    np.savez(path, **payload)
    print(f'[blowup] ring has {count} captures '
          f'({int(ring["total_bad"])} bad envs total); latest '
          f'{int(keep.sum())} snapshot(s) -> {path}', flush=True)
    return count

  # ------------------------------------------------------------------
  # context
  # ------------------------------------------------------------------
  def _make_ctx(self, state: EnvState) -> EnvCtx:
    origins = self.scene.env_origins
    if self._origin_term is not None:
      curr = state.curriculum.get(self._origin_term)
      if curr is not None:
        origins = curr['origins']
    return EnvCtx(
        model=state.model, data=state.data, scene=self.scene, state=state,
        actions=state.actions, prev_actions=state.prev_actions,
        commands=self.command_manager.values(state.command),
        command_terms=self.command_manager.terms,
        episode_length=state.episode_length,
        step_dt=self.step_dt, physics_dt=self.physics_dt,
        max_episode_length=self.max_episode_length,
        num_envs=self.num_envs,
        env_origins=origins,
        terminated=torch.zeros(self.num_envs, dtype=torch.bool,
                               device=self.device),
        generator=self._gen, world=self.world)

  # ------------------------------------------------------------------
  # functional core
  # ------------------------------------------------------------------
  def _reset_masked(self, state: EnvState, mask: torch.Tensor,
                    term_info: dict):
    """Masked reset of the selected envs, and the episode logs.

    Order: curriculum -> scene reset -> command reset -> reset events ->
    observation buffers -> logs. The command reset comes before the reset
    events on purpose: events may read the freshly resampled command."""
    gen = self._gen
    dtype = state.data.qpos.dtype
    ctx = self._make_ctx(state)
    # expose which envs terminated (vs timed out) to reset-time consumers
    terminated = torch.zeros_like(mask)
    for name, flag in term_info.items():
      if not self.termination_manager.terms[name].time_out:
        terminated = terminated | flag
    ctx.terminated = terminated
    extras = {}
    cnt = mask.sum().to(torch.float32)
    tracing.count('resets', cnt)
    safe_cnt = cnt.clamp_min(1.0)

    def mean_over_reset(v):
      return torch.where(mask, v, torch.zeros_like(v)).sum() / safe_cnt

    # curriculum (runs on the envs that reset)
    curr_state, curr_metrics = self.curriculum_manager.compute(
        ctx, state.curriculum, mask)
    extras.update({k: torch.as_tensor(v, dtype=torch.float32,
                                      device=self.device)
                   for k, v in curr_metrics.items()})
    # rebuild ctx so the command reset below samples from the ranges the
    # curriculum has just set, and the reset events spawn at the origins
    # the terrain-level curriculum has just moved
    state = state.replace(curriculum=curr_state)
    ctx = self._make_ctx(state)
    ctx.terminated = terminated

    # scene reset: clear per-entity external forces
    data = state.data
    for name in self.scene.entities:
      data = self.scene[name].reset(data, mask)

    # command reset + metric logging
    ctx = dataclasses.replace(ctx, data=data)
    cmd_state, cmd_metrics = self.command_manager.reset(
        state.command, ctx, mask, gen)
    for k, v in cmd_metrics.items():
      extras[k] = mean_over_reset(v)

    # reset events (may touch data and per-env model fields)
    ctx = dataclasses.replace(
        ctx, data=data, state=state.replace(command=cmd_state))
    data, model, ev_state = self.event_manager.apply_reset(
        ctx, data, state.model, state.event, mask, gen, state.common_step)

    # observation buffers
    obs_state = self.observation_manager.reset(state.obs, mask, gen)

    # episode logs
    for i, name in enumerate(self.reward_manager.active_terms):
      extras[f'Episode_Reward/{name}'] = mean_over_reset(
          state.reward_sums[:, i] / self.cfg.episode_length_s)
    for name, flag in term_info.items():
      extras[f'Episode_Termination/{name}'] = (flag & mask).sum().to(
          torch.float32)
    extras['reset_count'] = cnt
    # true episode length at reset
    extras['episode_length_sum'] = torch.where(
        mask, state.episode_length,
        torch.zeros_like(state.episode_length)).sum().to(torch.float32)

    rows = mask[:, None]
    zero = torch.zeros((), dtype=dtype, device=self.device)
    state = state.replace(
        model=model, data=data, command=cmd_state, obs=obs_state,
        event=ev_state, curriculum=curr_state,
        reward_sums=torch.where(rows, zero, state.reward_sums),
        episode_length=torch.where(
            mask, torch.zeros_like(state.episode_length),
            state.episode_length),
        actions=torch.where(rows, zero, state.actions),
        prev_actions=torch.where(rows, zero, state.prev_actions),
        reward=self.reward_manager.reset_state(state.reward, mask))
    return state, extras

  def _step_fn(self, state: EnvState, action: torch.Tensor,
               stage=_STAGE):
    """One env-step, in the span env.step. `stage(name)` gives a context
    manager that wraps each named stage of the step (a profiler's hook; by
    default the span env.<name>, nothing without a profiler)."""
    with tracing.span('env.step'):
      gen = self._gen
      action = torch.as_tensor(action, dtype=state.actions.dtype,
                               device=self.device)

      # action processing
      with stage('action'):
        processed = self.action_manager.process(action)
        state = state.replace(actions=action, prev_actions=state.actions)

      # decimation loop
      ctx = self._make_ctx(state)
      pre = data = state.data  # pre: the forensic ring's capture
      qvel_peaks = []
      for _ in range(self.cfg.decimation):
        with stage('action'):
          data = self.action_manager.apply(ctx, data, processed)
        with stage('substeps'):
          data = phys_pipeline.step(state.model, data)
          qvel_peaks.append(data.qvel.abs().amax(dim=-1))

      # physics blowup guard: an env whose state went non-finite (float32
      # contact-force overflow) is force-terminated and reset this step, and
      # the whole Data is sanitized so that reward, observation and
      # normalizer math stays finite (comparisons with NaN are False, so the
      # ordinary terminations would miss these envs). Finite-but-exploding
      # states are flagged the same way, on the peak over the substeps, so an
      # explosion in the middle of a control step is caught at once.
      # Neither the forensic ring nor a NanGuard sees the sanitized state.
      with stage('guard'):
        fin = lambda a: torch.isfinite(a).all(dim=-1)
        nonfinite = ~(fin(data.qpos) & fin(data.qvel) & fin(data.qacc))
        qvel_peaks = torch.stack(qvel_peaks)
        phys_bad = nonfinite | (qvel_peaks.amax(dim=0)
                                > self.cfg.sanity_qvel_limit)
        if self._blowup_dump_dir:
          state = state.replace(forensic=self._forensic_write(
              state.forensic, phys_bad, pre, processed, state, qvel_peaks))
        state = state.replace(
            data=sanitize(data),
            episode_length=state.episode_length + 1,
            common_step=state.common_step + 1)
        guard = self.nan_guard
        if guard is not None:
          guard.observe(nonfinite, data.qpos, data.qvel, data.qacc, data.time,
                        state.common_step)

      # terminations + rewards
      ctx = self._make_ctx(state)
      with stage('terminations'):
        terminated, truncated, term_info = self.termination_manager.compute(
            ctx)
        terminated = terminated | phys_bad
        ctx.terminated = terminated
      with stage('rewards'):
        reward, sums, _, rew_state = self.reward_manager.compute(
            ctx, state.reward_sums, self.step_dt, state.reward)
        reward = torch.where(phys_bad, torch.zeros_like(reward), reward)
        state = state.replace(reward_sums=sums, reward=rew_state)

      # masked partial reset, then the forward refresh of every env if any
      # env reset: the step's one host read of a device value, which also
      # reads an attached NanGuard's flag
      done = terminated | truncated
      with stage('reset'):
        state, extras = self._reset_masked(state, done, term_info)
      with stage('refresh'):
        any_done = done.any()
        if self.world.sharded:
          flag, = all_reduce_flat([any_done.to(torch.float32)], self.world,
                                  'max')
          any_done = flag > 0
        if guard is None:
          refresh = bool(any_done)
        else:
          refresh, blew_up = torch.stack((any_done, nonfinite.any())).tolist()
          guard.settle(blew_up)
        if refresh:
          state = state.replace(
              data=phys_pipeline.forward(state.model, state.data))

      # command update
      with stage('commands'):
        cmd_state = self.command_manager.compute(
            state.command, self._make_ctx(state), gen, self.step_dt)
        state = state.replace(command=cmd_state)

      # interval events (pushes etc.)
      with stage('events'):
        data, ev_state = self.event_manager.apply_interval(
            self._make_ctx(state), state.data, state.event, gen)
        state = state.replace(data=data, event=ev_state)

      # observations
      with stage('observations'):
        obs, obs_state = self.observation_manager.compute(
            self._make_ctx(state), state.obs, gen)
        state = state.replace(obs=obs_state)

      extras['time_outs'] = truncated
      extras['Episode_Termination/physics_nan'] = phys_bad.sum()
      return state, (obs, reward, terminated, truncated, extras)

  def _reset_fn(self, state: EnvState):
    gen = self._gen
    mask = torch.ones(self.num_envs, dtype=torch.bool, device=self.device)
    term_info = {n: torch.zeros_like(mask)
                 for n in self.termination_manager.active_terms}
    state, _ = self._reset_masked(state, mask, term_info)
    state = state.replace(
        data=phys_pipeline.forward(state.model, state.data))
    cmd_state = self.command_manager.compute(
        state.command, self._make_ctx(state), gen, 0.0)
    state = state.replace(command=cmd_state)
    obs, obs_state = self.observation_manager.compute(
        self._make_ctx(state), state.obs, gen)
    return state.replace(obs=obs_state), obs

  def init_state(self, seed: 'int | None' = None):
    """(state, obs) of a fresh episode in every env; reseeds the env's
    generator with `seed` (default cfg.seed)."""
    self._gen.manual_seed(self.cfg.seed if seed is None else seed)
    return self._reset_fn(self._template_state)

  @property
  def step_fn(self):
    return self._step_fn

  @property
  def generator(self) -> torch.Generator:
    """The env's one generator (reseeded by `init_state`)."""
    return self._gen

  @property
  def replicated_state(self) -> frozenset:
    """Paths ('/'-joined keys of envs/io.py's env_state_to_numpy tree) of
    the state that every rank of a sharded env holds alike, as its terms
    name it: parallel.sharding's `replicated_paths` for this env's state."""
    return frozenset(
        [f'command/{p}' for p in self.command_manager.replicated_state()]
        + [f'curriculum/{p}'
           for p in self.curriculum_manager.replicated_state()])

  # ------------------------------------------------------------------
  # gym-like stateful API
  # ------------------------------------------------------------------
  def reset(self, seed: 'int | None' = None):
    self._state, obs = self.init_state(seed)
    # the fresh state's forensic ring is empty: re-sync the host's count, or
    # captures after the reset would be skipped until the device's count
    # passed the old one
    self._blowup_count = 0
    return obs, {}

  def step(self, action):
    if self._state is None:
      self.reset()
    self._state, out = self._step_fn(self._state, action)
    # extras stay on the device; fetching them is the consumer's choice
    self.last_extras = out[4]
    return out

  @property
  def state(self) -> EnvState:
    return self._state

  @property
  def action_dim(self) -> int:
    return self.action_manager.total_dim

  @property
  def observation_dims(self) -> dict:
    return {g: self.observation_manager.group_dim(g)
            for g in self.observation_manager.groups}
