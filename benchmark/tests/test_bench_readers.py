"""Each per-layer metric's reader on a synthetic profiler record, with the
numbers worked out by hand; on an empty record every reader finds
nothing."""

import json

import pytest
import torch

from benchmark.lib import readers, spec, trace, work
from benchmark.tests.test_bench_work import _newton_args

BENCH = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())
PER_LAYER = [m['name'] for m in BENCH['per_layer']]


def _x(name, cat, ts, dur, corr=None):
  e = {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur}
  if corr is not None:
    e['args'] = {'correlation': corr}
  return e


def synthetic_trace() -> dict:
  """A window of 1000 us with two env-steps. Kernels (device time, launch):
  step 1: collision 30 us (launched at 25), newton 40 us (at 60, inside
  solve), another kernel of solve 10 us (at 70), smooth 5 us (at 15), a
  kernel outside every entry 15 us (at 300); step 2: collision 20 us (at
  515), newton 60 us (at 560), solve's other kernel 10 us (at 570), smooth
  5 us (at 504). Device intervals do not overlap; their union is 195.5 us."""
  ev = [_x('bench.window', 'user_annotation', 0, 1000)]
  for k, s in enumerate((10, 500)):
    ev += [_x('bench.env_step', 'user_annotation', s, 400),
           _x('entry.smooth', 'user_annotation', s + 2, 4),
           _x('entry.collision', 'user_annotation', s + 10, 10),
           _x('entry.solve', 'user_annotation', s + 40, 40),
           _x('entry.newton', 'user_annotation', s + 45, 10),
           _x('entry.pd_solve', 'user_annotation', s + 200, 10)]
  kernels = [  # name, launch, start, dur
      ('smooth_kernel<false>', 15, 100, 5), ('collide', 25, 110, 30),
      ('newton_kernel', 60, 150, 40), ('solve_other', 70, 200, 10),
      ('pd_solve_kernel', 215, 215, 0.5), ('elementwise', 300, 310, 15),
      ('smooth_kernel<false>', 504, 600, 5), ('collide', 515, 610, 20),
      ('newton_kernel', 560, 640, 60), ('solve_other', 570, 700, 10)]
  for i, (name, launch, start, dur) in enumerate(kernels):
    ev += [_x('cudaLaunchKernel', 'cuda_runtime', launch, 1, corr=i),
           _x(name, 'kernel', start, dur, corr=i)]
  return {'traceEvents': ev}


def record(captures=None) -> dict:
  rec = trace.parse(synthetic_trace())
  rec.update(steps=2, num_envs=3, kind='NVIDIA H100 80GB HBM3',
             mlp={'actor': [(3, 2), (2, 1)]}, update_passes=0,
             clock=[{'collection_ms': 10.0, 'learning_ms': 4.0},
                    {'collection_ms': 14.0, 'learning_ms': 6.0}],
             captures=captures or {})
  return rec


def test_parse_by_hand():
  rec = record()
  assert rec['window_s'] == pytest.approx(1e-3)
  assert rec['busy_s'] == pytest.approx(195.5e-6)
  assert rec['launch_matched'] == 10


def test_per_step_and_idle_readers_by_hand():
  rec = record()
  assert readers.device_ms_per_step(rec, 'entry.collision') == \
      pytest.approx((30 + 20) / 2 * 1e-3)
  assert readers.device_ms_per_step(rec, 'entry.solve') == \
      pytest.approx((40 + 10 + 60 + 10) / 2 * 1e-3)
  # every kernel launched inside an env-step: 6 in the first (the
  # elementwise one is launched at 300, inside it), 4 in the second
  assert readers.launches_per_step(rec) == pytest.approx(10 / 2)
  assert readers.device_idle_pct(rec) == pytest.approx(
      100 * (1 - 195.5 / 1000))
  assert readers.clock_mean_ms(rec, 'collection_ms') == pytest.approx(12.0)
  assert readers.first_call_s(rec, 'entry.newton') == pytest.approx(40e-6)


def test_roofline_and_mfu_by_hand():
  """K2's first call: 40 us on the device; its work, from the converged
  tiny problem (M = I, no rows, n = 2, B = 3): 72 FLOPs and 312 bytes, so
  the least time is 312 / 3.35e12 s and the share 100 * that / 40e-6."""
  n_args = _newton_args(3, 2, 1, 0)
  kw = {'iterations': 10, 'ls_polish': 1, 'ldof': (), 'grad_th': 1e-8}
  H = torch.eye(2).expand(3, 2, 2).clone()
  caps = {'entry.newton': (n_args, kw, None),
          'entry.pd_solve': ((H, torch.zeros(3, 2)), {}, None),
          'entry.smooth': ((_G1.model, torch.zeros(3, 36),
                            torch.zeros(3, 35)), {},
                           {'x': torch.zeros(3, 7)})}
  rec = record(caps)
  p = work.DEFAULT_PEAK
  nbytes, flops = 4 * 3 * (4 + 2 + 3 + 12 + 4 + 1), 3 * 24
  assert readers.roofline_pct(rec, 'entry.newton', readers.k2_work) == \
      pytest.approx(100 * max(nbytes / p['hbm_bytes'],
                              flops / p['f32_flops']) / 40e-6)
  k3 = 3 * (572 * 31 + 108 * 75 + 150 * 35 + 12 * 341)
  expect = (2 * k3 + 2 * flops + 2 * 3 * 15  # two calls of each kernel
            + 2 * 3 * (2 * 3 * 2 + 2 + 2 * 2 * 1 + 1))  # the actor
  assert readers.step_flops(rec) == expect
  assert readers.mfu_pct(rec) == pytest.approx(
      100 * expect / (1e-3 * p['f32_flops']))


class _G1:
  model = None


@pytest.fixture(autouse=True, scope='module')
def _g1_model():
  from mjlab_torch.tasks import registry
  _G1.model = registry.make('Mjlab-Velocity-Flat-Unitree-G1', device='cpu',
                            **{'scene.num_envs': 2}).model


@pytest.mark.parametrize('name', PER_LAYER)
def test_every_metric_file_reads_the_synthetic_record(name):
  mod = spec.metric_module(name)
  n_args = _newton_args(3, 2, 1, 0)
  kw = {'iterations': 10, 'ls_polish': 1, 'ldof': (), 'grad_th': 1e-8}
  caps = {'entry.newton': (n_args, kw, None),
          'entry.pd_solve': ((torch.eye(2).expand(3, 2, 2).clone(),
                              torch.zeros(3, 2)), {}, None),
          'entry.smooth': ((_G1.model, torch.zeros(3, 36),
                            torch.zeros(3, 35)), {},
                           {'x': torch.zeros(3, 7)})}
  rec = record(caps)
  rec['mlp']['critic'] = [(3, 1)]
  v = mod.read(rec)
  assert v is not None and v > 0
  unit = next(m['unit'] for m in BENCH['per_layer'] if m['name'] == name)
  if unit == '%':
    assert v <= 100


@pytest.mark.parametrize('name', PER_LAYER)
def test_every_metric_file_finds_nothing_in_an_empty_record(name):
  mod = spec.metric_module(name)
  rec = trace.parse({'traceEvents': [
      _x('bench.window', 'user_annotation', 0, 1000)]})
  rec.update(steps=2, num_envs=3, kind='cpu', mlp={}, update_passes=0,
             clock=[], captures={})
  assert mod.read(rec) is None


@pytest.mark.parametrize('name', PER_LAYER)
def test_every_metric_file_names_entries_that_exist(name):
  mod = spec.metric_module(name)
  for rng, target in getattr(mod, 'ENTRIES', {}).items():
    assert rng.startswith('entry.')
    assert trace.resolve(target) is not None, target
  assert set(getattr(mod, 'CAPTURE', ())) <= set(getattr(mod, 'ENTRIES', {}))


def test_breakdown_labels_idle_time_by_host_range():
  rec = record()
  b = trace.breakdown(rec)
  assert b['device_ops'][0] == ['newton_kernel', pytest.approx(100e-6)]
  assert len(b['device_ops']) <= 10 and len(b['idle_gaps']) <= 10
  total_idle = sum(v for _, v in b['idle_gaps'])
  assert total_idle == pytest.approx(1e-3 - 195.5e-6)
