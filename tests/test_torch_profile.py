"""The profile CLI (mjlab_torch/scripts/profile.py), its op counter
(utils/op_count.py) and the kernels' work counts (ops/work.py), on the CPU.

The CLI is held to the JAX script (mjlab_tpu/scripts/profile.py) by
reading that script's source with `ast`, without running it: the same
flags (`--cpu` becomes `--device`; `--chip` names this card and the CPU,
no TPU) and the same stage labels in the same order. One G1 flat env of 2
envs serves every run of the CLI here."""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import g1_flat_arrays
from mjlab_torch.ops import _build
from mjlab_torch.ops import newton as tnewton
from mjlab_torch.ops import pd_solve as tpd
from mjlab_torch.ops import smooth_kernel as tsk
from mjlab_torch.ops import work
from mjlab_torch.physics import constraint, pipeline, smooth, solver
from mjlab_torch.scripts import profile
from mjlab_torch.tasks import registry
from mjlab_torch.utils.op_count import OpCounter

# The env's ops are tiny: one intra-op thread is fastest and leaves the
# other test workers their cores (tests/torch_parity.py).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, 'mjlab_tpu', 'scripts', 'profile.py')
PORT_SCRIPT = os.path.join(ROOT, 'mjlab_torch', 'scripts', 'profile.py')
TASK = 'Mjlab-Velocity-Flat-Unitree-G1'
TPU_CHIPS = ('v4', 'v5e', 'v5p')


def _function(path: str, name: str) -> ast.FunctionDef:
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  return next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == name)


def _flags(path: str) -> dict:
  """{flag: {keyword: source}} of every parser.add_argument in main()."""
  flags = {}
  for node in ast.walk(_function(path, 'main')):
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and node.func.attr == 'add_argument'):
      flags[node.args[0].value] = {k.arg: ast.unparse(k.value)
                                   for k in node.keywords if k.arg != 'help'}
  return flags


def _jax_stage_labels() -> list:
  """The labels of the JAX `_phase_report`'s `_timeit` calls, in source
  order."""
  calls = [n for n in ast.walk(_function(JAX_SCRIPT, '_phase_report'))
           if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
           and n.func.id == '_timeit']
  calls.sort(key=lambda n: (n.lineno, n.col_offset))
  return [n.args[0].value for n in calls]


@pytest.fixture(scope='module')
def g1_env():
  return registry.make(TASK, device='cpu', **{'scene.num_envs': 2})


@pytest.fixture
def run(g1_env, monkeypatch, capsys):
  """main(argv) on the CPU at 2 envs, on the module's one env; returns
  (its report, what it printed)."""
  monkeypatch.setattr(registry, 'make', lambda task, cfg, device: g1_env)

  def go(*argv):
    report = profile.main(['--device', 'cpu', '--num-envs', '2', '--reps',
                           '1', *argv])
    return report, capsys.readouterr().out

  return go


# ---- the CLI surface against the JAX script --------------------------------

def test_flags_are_the_jax_scripts():
  jax_flags, port = _flags(JAX_SCRIPT), _flags(PORT_SCRIPT)
  assert set(port) == set(jax_flags) - {'--cpu'} | {'--device'}
  for flag in set(jax_flags) - {'--cpu', '--chip'}:
    assert port[flag] == jax_flags[flag], flag
  assert port['--device'] == {'default': "'cuda'"}
  assert port['--chip']['default'] == "'h100-sxm'"
  assert sorted(profile._CHIP_PEAKS) == ['cpu', 'h100-sxm']
  assert not set(profile._CHIP_PEAKS) & set(TPU_CHIPS)
  assert profile._CHIP_PEAKS['h100-sxm'] == (67e12, 3.35e12)
  assert all(math.isnan(p) for p in profile._CHIP_PEAKS['cpu'])


def test_stage_report_prints_the_jax_labels_in_order(run):
  labels = _jax_stage_labels()
  assert labels[0] == 'full substep (fused)' and len(labels) == 13
  report, out = run()
  assert list(report['phases']) == labels
  assert all(math.isfinite(v) and v > 0 for v in report['phases'].values())
  lines = out.splitlines()
  assert lines[0] == f'=== {TASK} N=2 device=cpu ==='
  assert lines[1].startswith('pairs ncon_max=533 ncon_cap=32 nv=35')
  assert lines[2] == 'efc rows: nf=35 nl=29 ncr=144 total=208'
  assert [ln[:30].rstrip() for ln in lines[3:3 + len(labels)]] == labels
  assert all(ln.endswith(' ms') for ln in lines[3:3 + len(labels)])
  assert lines[-1].startswith('full env.step') and 'env-steps/s' in lines[-1]
  assert math.isfinite(report['env_step_s']) and report['env_step_s'] > 0


def test_roofline_and_trace_on_the_cpu(run, tmp_path):
  report, out = run('--roofline', '--chip', 'cpu', '--trace', str(tmp_path))
  assert 'phases' not in report
  for name in ('physics substep', 'full env.step'):
    r = report['roofline'][name]
    assert all(math.isfinite(r[k]) and r[k] > 0
               for k in ('flops', 'bytes', 'seconds')), name
    assert r['kernels'] == {}  # the CPU takes the plain versions
    assert f'\n{name:30s} ' in out
  # an env-step is four substeps and the managers
  step, sub = (report['roofline'][k] for k in ('full env.step',
                                               'physics substep'))
  assert step['flops'] > 4 * sub['flops'] * 0.99
  assert out.count('% of f32 peak; eager op count)') == 2
  assert out.count('  nan% of f32 peak') == 2
  assert out.count('  nan% of HBM peak, apparent') == 2
  assert out.count('(ridge nan -> bandwidth-bound)') == 2

  trace = report['trace']
  assert os.path.dirname(trace['path']) == str(tmp_path)
  assert trace['path'].endswith('.json')
  assert trace['kernels'] == {} and trace['host']
  assert all(v >= 0 for v in trace['host'].values())
  assert '--- host ops: top 25 by total time ---' in out
  assert '[trace] memory counters unavailable (no CUDA device)' in out
  assert trace['counters'] == {'available': False, 'reason': 'no CUDA device'}
  with open(trace['path']) as f:
    events = json.load(f)['traceEvents']
  ops = {e['name'] for e in events if e.get('cat') == 'cpu_op'}
  assert set(trace['host']) == ops
  os.remove(trace['path'])


# ---- the op counter ----------------------------------------------------------

@pytest.mark.parametrize('case', ['matmul', 'view', 'add', 'sum_last',
                                  'in_place', 'copy'])
def test_counter_on_known_ops(case):
  m, k, n = 3, 4, 5
  a = torch.randn(m, k)
  b = torch.randn(k, n)
  with OpCounter('cpu') as c:
    if case == 'matmul':
      a @ b
    elif case == 'view':
      a.view(k, m), a.t(), a[:, 1], a.expand(2, m, k)
    elif case == 'add':
      a + a
    elif case == 'sum_last':
      a.sum(-1)
    elif case == 'in_place':
      a.add_(1.0)
    elif case == 'copy':
      a.copy_(b.t()[:m])
  want = {'matmul': (2 * m * k * n, 4 * (m * k + k * n + m * n)),
          'view': (0, 0),
          'add': (m * k, 4 * 3 * m * k),
          'sum_last': (m * k, 4 * (m * k + m)),
          'in_place': (m * k, 4 * 2 * m * k),  # reads a, writes a
          'copy': (0, 4 * 2 * m * k)}[case]  # reads b's slice, writes a
  assert (c.flops, c.bytes) == want


def test_counter_counts_only_its_device():
  a = torch.randn(8)
  with OpCounter('cuda') as c:
    a + a
  assert (c.flops, c.bytes, dict(c.ops)) == (0, 0, {})


def test_charge_is_added_and_its_ops_are_not_counted():
  before = dict(_build.LAUNCHES)

  def work_of_a_call():
    assert _build.COUNTER is None  # a kernel inside is charged to no one
    _build.LAUNCHES['pd_solve'] += 1  # ... and leaves no launch behind
    return int(torch.ones(100).sum()) * 0 + 7, 11

  assert _build.COUNTER is None
  with OpCounter('cpu') as c:
    assert _build.COUNTER is c
    c.charge('pd_solve', work_of_a_call)
    c.charge('pd_solve', work_of_a_call)
  assert _build.COUNTER is None
  assert (c.bytes, c.flops, dict(c.ops)) == (14, 22, {})
  assert dict(c.kernels) == {'pd_solve': [2, 14, 22]}
  assert dict(_build.LAUNCHES) == before


class _FakeLibrary:
  """A kernel library whose functions return 0 and launch nothing, so
  that a wrapper runs on the CPU up to its charge."""

  def __getattr__(self, name):
    fn = lambda *args: 0 if name.endswith('_launch') else (
        10**6 if name.endswith('max_n') else 1)
    self.__dict__[name] = fn
    return fn


@pytest.fixture
def fake_kernels(monkeypatch):
  monkeypatch.setattr(_build, 'library', lambda name: _FakeLibrary())
  monkeypatch.setattr(_build, 'require', lambda *a, **k: None)
  monkeypatch.setattr(_build, 'stream_ptr', lambda t: 0)
  monkeypatch.setattr(tpd, 'max_n', lambda: 10**6)
  monkeypatch.setattr(tnewton, 'fits', lambda n, ncr, nl: True)
  before = dict(_build.LAUNCHES)
  yield
  _build.LAUNCHES.clear()
  _build.LAUNCHES.update(before)


def test_wrappers_charge_their_work(fake_kernels):
  """K1 and K2's wrappers charge ops/work.py's counts to an active
  counter and nothing without one; the plain Newton solve that counts
  K2's steps is not counted as the program's."""
  H = torch.eye(35).expand(4, 35, 35).contiguous()
  g = torch.ones(4, 35)
  args, iters, polish, ldof, grad_th = _k2_problem()
  tpd.solve_pd_cuda(H, g)  # no counter: nothing to charge
  with OpCounter('cpu') as c:
    tpd.solve_pd_cuda(H, g)
    tnewton.newton_solve_cuda(*args, iterations=iters, ls_polish=polish,
                              ldof=ldof, grad_th=grad_th)
  k2 = work.newton_work(args, iters, polish, ldof, grad_th)
  assert dict(c.kernels) == {
      'pd_solve': [1, *work.pd_solve_work(H, g)],
      'newton': [1, k2[3], k2[4]]}
  # what the wrappers dispatch themselves: their outputs and contiguous
  # copies of the arguments, and none of the plain solve's arithmetic
  assert set(c.ops) <= {'empty_like', 'empty', 'lift_fresh', '_to_copy',
                        'clone'}
  assert c.flops == sum(v[2] for v in c.kernels.values())


# ---- the kernels' work counts (ops/work.py) --------------------------------

def test_chol_solve_flops_by_hand():
  # column j: the pivot (j products, j sums, the root, its reciprocal) and
  # each of the n - 1 - j entries below it (j products, j sums, a scale);
  # then forward and back substitution, n^2 FLOPs each
  assert work.chol_solve_flops(1) == 2 + 2 * 1
  assert work.chol_solve_flops(2) == (2 + 1) + 4 + 2 * 4
  assert work.chol_solve_flops(3) == (2 + 2 * 1) + (4 + 3) + 6 + 2 * 9
  assert work.pd_solve_work(torch.zeros(4, 35, 35), torch.zeros(4, 35)) == (
      4 * 4 * (35 * 35 + 2 * 35), 4 * work.chol_solve_flops(35))


def test_bound_ms_takes_the_larger_time():
  assert work.bound_ms(3.35e9, 0.0) == (1.0, 'bytes')
  assert work.bound_ms(0.0, 67e9) == (1.0, 'operations')
  assert work.bound_ms(3.35e9, 2 * 67e9) == (2.0, 'operations')


def _g1_states(m, mj, batch: int, drop: float, seed: int):
  """`batch` G1 flat envs near the keyframe in float32 from numpy's
  default_rng(seed): joint noise, velocities, the root lowered `drop` m."""
  rng = np.random.default_rng(seed)
  s = m.stat
  qpos = np.tile(np.asarray(mj.key_qpos[0], np.float64), (batch, 1))
  qpos[:, 7:] += 0.05 * rng.normal(size=(batch, s.nq - 7))
  qpos[:, 2] -= drop
  qvel = 0.5 * rng.normal(size=(batch, s.nv))
  d = tphys.make_batched_data(m, batch, device='cpu')
  f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)
  return d.replace(qpos=f32(qpos), qvel=f32(qvel), ctrl=f32(
      np.tile(mj.key_ctrl[0], (batch, 1))))


def _k2_problem():
  """K2's arguments for 4 G1 flat envs lowered 5 mm into the floor."""
  mj = g1_flat_arrays()
  m = tphys.put_model(mj, device='cpu')
  d = _g1_states(m, mj, 4, 0.005, 1)
  d = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  d = smooth.fwd_smooth(m, smooth.actuation(m, d))
  args = solver.newton_args(d, constraint.make_efc(m, d))
  return (list(args), *solver.solver_params(m.stat))


def test_work_counts_are_chip_smokes():
  """K3's and K2's counts on a small CPU problem are those the functions
  gave when they lived in chip_smoke.py (written down from them)."""
  mj = g1_flat_arrays()
  m = tphys.put_model(mj, device='cpu')
  d = _g1_states(m, mj, 4, 0.0, 0)
  plan = tsk.plan_of(m)
  outs = {k: torch.empty((4,) + sh)
          for k, sh in zip(tsk.OUT_KEYS, plan.shapes)}
  assert work.k3_work(m, d.qpos, d.qvel, outs) == (81504, 140696)
  need, nc, rows, nbytes, flops = work.newton_work(*_k2_problem())
  assert need.tolist() == [10, 10, 10, 10]
  assert nc.tolist() == rows.tolist() == [76, 68, 20, 40]
  assert (nbytes, flops) == (116256, 4220280)
