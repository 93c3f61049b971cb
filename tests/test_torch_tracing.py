"""The port's spans and counters (mjlab_torch/utils/tracing.py) on the CPU.

Without a profiler they do nothing: no profiler range is entered, nothing
is kept, and a span or a count launches no op, allocates nothing and reads
no tensor. Under torch.profiler an env-step records env.step once and the
seven physics stages in every substep, each inside physics.step with no op
of the substep outside them, and once more in the refresh's forward after a
reset; a learn iteration records the learner's spans; the counters hold
each collision call's active contacts and each env-step's resets. The
port's functions and attributes that the benchmark patches by name still
resolve, and the pipeline and the learner still call them through those
names."""

import bisect
import collections
import inspect
import tracemalloc

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.lib import trace
from mjlab_torch.physics import collision as collision_mod
from mjlab_torch.physics import pipeline
from mjlab_torch.physics import solver as solver_mod
from mjlab_torch.rl.ppo import PPO
from mjlab_torch.tasks import registry
from mjlab_torch.utils import tracing
from torch_parity import G1_FLAT_TASK

PHYSICS = ('kinematics', 'collision', 'dynamics', 'constraint', 'solve',
           'sensor', 'integrate')
ENV_STAGES = ('action', 'substeps', 'guard', 'terminations', 'rewards',
              'reset', 'refresh', 'commands', 'events', 'observations')
READS = ('__bool__', 'item', 'nonzero', 'cpu', 'tolist', 'numpy', '__int__',
         '__float__', '__index__')
# what the benchmark's code patches by name (benchmark/lib/readers.py,
# benchmark/lib/drivers.py, benchmark/lib/tree.py)
TARGETS = ('mjlab_torch.physics.collision:collision',
           'mjlab_torch.physics.solver:solve',
           'mjlab_torch.ops.smooth_kernel:smooth_fused_cuda',
           'mjlab_torch.ops.newton:newton_solve_cuda',
           'mjlab_torch.ops.pd_solve:solve_pd_cuda',
           'mjlab_torch.physics.pipeline:step',
           'mjlab_torch.envs.manager_based_rl_env:sanitize')
PPO_ATTRS = ('_step_fn', '_rollout', '_gae', '_update', '_loss')


@pytest.fixture(scope='module')
def g1_env():
  return registry.make(G1_FLAT_TASK, device='cpu', **{'scene.num_envs': 2})


@pytest.fixture(autouse=True)
def _nothing_kept():
  tracing.reset_counters()
  yield
  tracing.reset_counters()


def _ppo_cfg():
  cfg = registry.load_cfg(G1_FLAT_TASK, 'rl_cfg_entry_point')
  cfg.device = 'cpu'
  cfg.num_steps_per_env = 2
  cfg.policy.actor_hidden_dims = (16, 16)
  cfg.policy.critic_hidden_dims = (16,)
  return cfg


class _Ops(TorchDispatchMode):
  """Every aten op dispatched while it is active."""

  def __init__(self):
    super().__init__()
    self.ops = []

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.ops.append(func)
    return func(*args, **(kwargs or {}))


def _count_reads(monkeypatch, calls: list) -> None:
  for name in READS:
    orig = getattr(torch.Tensor, name)

    def counted(self, *a, _orig=orig, _name=name, **kw):
      calls.append(_name)
      return _orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, name, counted)


def _trace(prof) -> tuple:
  """([(name, start, end)] of the trace's ranges, the same of its aten
  ops), in us, from its Chrome trace (FunctionEvents take ten times as
  long to build)."""
  ev = [e for e in trace.export(prof)['traceEvents'] if e.get('ph') == 'X']
  iv = lambda e: (e['name'], float(e['ts']),
                  float(e['ts']) + float(e.get('dur', 0)))
  return ([iv(e) for e in ev if e.get('cat') == 'user_annotation'],
          [iv(e) for e in ev if e.get('cat') == 'cpu_op'])


def _within(e, r) -> bool:
  return r[1] <= e[1] and e[2] <= r[2]


def _covered(e, intervals: list) -> bool:
  """Whether `e` lies inside one of the sorted, disjoint `intervals`."""
  i = bisect.bisect_right(intervals, (e[1], float('inf'))) - 1
  return i >= 0 and e[2] <= intervals[i][1]


def test_off_the_env_step_enters_no_range_and_keeps_nothing(g1_env,
                                                          monkeypatch):
  assert not tracing.recording()
  assert tracing.span('physics.step') is tracing.OFF
  assert tracing.stages('env.')('reset') is tracing.OFF
  entered = []

  class Counted:
    def __init__(self, name):
      entered.append(name)

    def __enter__(self):
      return self

    def __exit__(self, *exc):
      return False

  monkeypatch.setattr(torch.profiler, 'record_function', Counted)
  monkeypatch.setattr(torch.autograd.profiler, 'record_function', Counted)
  g1_env.reset(0)
  g1_env.step(torch.zeros(g1_env.num_envs, g1_env.action_dim))
  assert entered == []
  assert tracing.counters() == {}


def test_off_a_span_and_a_count_launch_allocate_and_read_nothing(
    monkeypatch):
  t = torch.arange(4, dtype=torch.int32)
  hook = tracing.stages('env.')

  def body(n):
    for _ in range(n):
      with tracing.span('physics.step'), hook('substeps'):
        tracing.count('contacts_active', t)

  with _Ops() as mode:
    body(10)
  assert mode.ops == []
  calls = []
  _count_reads(monkeypatch, calls)
  body(10)
  monkeypatch.undo()
  assert calls == []
  body(10)  # warm
  tracemalloc.start()
  try:
    before = tracemalloc.take_snapshot()
    body(1000)
    after = tracemalloc.take_snapshot()
  finally:
    tracemalloc.stop()
  only = [tracemalloc.Filter(True, tracing.__file__)]
  grown = after.filter_traces(only).compare_to(
      before.filter_traces(only), 'lineno')
  assert sum(s.size_diff for s in grown) == 0, grown
  assert tracing.counters() == {}


def test_an_env_step_under_the_profiler(g1_env, monkeypatch):
  """env.step once; each physics stage once in every substep, inside
  physics.step, which launches no op outside them; the refresh's forward
  after env 0's time-out records the six forward stages once more; the
  counters hold every collision call's active contacts and the step's
  resets, and keep the step's one host read."""
  action = torch.zeros(g1_env.num_envs, g1_env.action_dim)
  g1_env.reset(0)
  g1_env.step(action)  # to the ground: contacts
  state = g1_env.state
  n = g1_env.cfg.decimation
  g1_env._state = state.replace(episode_length=torch.tensor(
      [g1_env.max_episode_length - 1, 0], dtype=state.episode_length.dtype))
  orig = collision_mod.collision
  active = []

  def collision(m, d):
    out = orig(m, d)
    active.append(out.ncon_active.clone())
    return out

  monkeypatch.setattr(collision_mod, 'collision', collision)
  calls = []
  with torch.profiler.profile() as prof:
    _count_reads(monkeypatch, calls)
    *_, extras = g1_env.step(action)
    monkeypatch.undo()
  assert calls == ['__bool__']
  spans, ops = _trace(prof)
  names = collections.Counter(e[0] for e in spans)
  assert names['env.step'] == 1
  assert {f'env.{s}' for s in ENV_STAGES} <= set(names)
  assert names['env.substeps'] == n and names['env.action'] == n + 1
  steps = sorted(e[1:] for e in spans if e[0] == 'physics.step')
  assert len(steps) == n
  stages = [e for e in spans if e[0] in {f'physics.{s}' for s in PHYSICS}]
  for s in PHYSICS:
    mine = [e for e in stages if e[0] == f'physics.{s}']
    assert sum(_covered(e, steps) for e in mine) == n, s
    assert len(mine) == n + (s != 'integrate'), s  # the refresh's forward
  ops = [e for e in ops if _covered(e, steps)]
  assert ops
  in_stages = sorted(e[1:] for e in stages)
  assert all(_covered(e, in_stages) for e in ops)

  reset = float(extras['reset_count'])
  assert reset == 1.0
  got = tracing.counters()
  assert got['resets'] == (reset, 1, 1)
  assert len(active) == n + 1
  assert got['contacts_active'] == (float(sum(a.sum() for a in active)),
                                    sum(a.numel() for a in active), n + 1)
  assert got['contacts_active'][0] > 0


@pytest.mark.parametrize('clock', [True, False])
def test_a_learn_iteration_under_the_profiler(g1_env, clock):
  """ppo.collection and ppo.learning, from the StageClock or from
  `_learn_iteration`'s default hook; ppo.act at every env-step of the
  rollout, ppo.gae and ppo.update in learning; the learner calls its
  parts through the attributes the benchmark patches."""
  ppo = PPO(g1_env, _ppo_cfg())
  ts = ppo.init_state(0)
  called = []
  for name in PPO_ATTRS[:4]:
    orig = getattr(ppo, name)

    def wrapped(*a, _orig=orig, _name=name):
      called.append(_name)
      return _orig(*a)

    setattr(ppo, name, wrapped)
  with torch.profiler.profile() as prof:
    if clock:
      ppo.learn_iteration(ts)
    else:
      ppo._learn_iteration(ts)
  spans, _ = _trace(prof)
  names = collections.Counter(e[0] for e in spans)
  T = ppo.cfg.num_steps_per_env
  assert names['ppo.collection'] == names['ppo.learning'] == 1
  assert names['ppo.act'] == names['env.step'] == T
  assert names['ppo.gae'] == names['ppo.update'] == 1
  collection, learning = (next(e for e in spans if e[0] == f'ppo.{s}')
                          for s in ('collection', 'learning'))
  assert all(_within(e, collection) for e in spans
             if e[0] in ('ppo.act', 'env.step'))
  assert all(_within(e, learning) for e in spans
             if e[0] in ('ppo.gae', 'ppo.update'))
  assert collections.Counter(called) == {'_rollout': 1, '_step_fn': T,
                                         '_gae': 1, '_update': 1}
  assert tracing.counters()['resets'][2] == T


def test_what_the_benchmark_patches_resolves(g1_env, monkeypatch):
  for target in TARGETS:
    assert trace.resolve(target) is not None, target
  ppo = PPO(g1_env, _ppo_cfg())
  for attr in PPO_ATTRS:
    assert callable(getattr(ppo, attr)), attr
  assert 'stage' in inspect.signature(g1_env._step_fn).parameters
  g1_env.reset(0)
  called = []
  for mod, name in ((collision_mod, 'collision'), (solver_mod, 'solve')):
    orig = getattr(mod, name)

    def wrapped(*a, _orig=orig, _name=name):
      called.append(_name)
      return _orig(*a)

    monkeypatch.setattr(mod, name, wrapped)
  pipeline.step(g1_env.state.model, g1_env.state.data)
  assert called == ['collision', 'solve']


def test_the_contact_rows_counter_on_the_cpu(g1_env):
  """Each make_efc of an env-step counts whether K4 built its contact rows:
  0.0 on the CPU, where the plain version does, in every substep and in
  the refresh's forward; nothing without a profiler."""
  action = torch.zeros(g1_env.num_envs, g1_env.action_dim)
  g1_env.reset(0)
  g1_env.step(action)
  assert 'contact_rows_kernel' not in tracing.counters()
  state = g1_env.state
  n = g1_env.cfg.decimation
  g1_env._state = state.replace(episode_length=torch.tensor(
      [g1_env.max_episode_length - 1, 0], dtype=state.episode_length.dtype))
  with torch.profiler.profile():
    g1_env.step(action)
  assert tracing.counters()['contact_rows_kernel'] == (0.0, n + 1, n + 1)
