"""The readers of the port's own spans and counters
(benchmark/lib/program_spans.py) on a synthetic record with hand-placed
physics.* spans, device operations and idle gaps, with the numbers worked
out by hand; each finds nothing where its span, its device operations or
its counter are absent."""

import json
import sys

import pytest
import torch

from benchmark.lib import program_spans, readers, spec, trace
from benchmark.tests.test_bench_readers import _x

BENCH = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())
STAGES = ('kinematics', 'collision', 'dynamics', 'constraint', 'solve',
          'sensor', 'integrate')
# (start, length) of each physics.* span in an env-step that starts at s,
# relative to s; physics.step holds the seven stages
SPANS = {'physics.step': (10, 100), 'physics.kinematics': (10, 10),
         'physics.collision': (20, 30), 'entry.collision': (21, 28),
         'physics.dynamics': (50, 20), 'physics.constraint': (70, 10),
         'physics.solve': (80, 10), 'entry.solve': (81, 8),
         'physics.sensor': (90, 5), 'physics.integrate': (95, 15)}
# (stage, launch, start on the device, length) relative to s
KERNELS = (('kinematics', 15, 90, 4), ('collision', 25, 100, 30),
           ('dynamics', 55, 130, 20), ('constraint', 75, 150, 6),
           ('solve', 85, 160, 40), ('sensor', 92, 200, 2),
           ('integrate', 100, 205, 5))
PER_STEP = {st: dur for st, _, _, dur in KERNELS}


def synthetic_trace() -> dict:
  """A window of 1000 us with two env-steps, at s = 10 and 500. Each
  launches one kernel from each physics stage (KERNELS); the first also
  runs a refresh's physics.kinematics span at 285-295 that launches a
  15 us kernel (at 290, on the device at 300), the second launches a
  10 us kernel outside every physics span (at 750, on the device at 800).
  The idle gaps whose midpoint lies inside a physics span: 0-100 (to the
  first kernel, midpoint 50, inside physics.step 20-120), 104-110 and
  594-600 (midpoints 107 and 597): 112 us."""
  ev = [_x('bench.window', 'user_annotation', 0, 1000)]
  kernels = []
  for s in (10, 500):
    ev.append(_x('bench.env_step', 'user_annotation', s, 400))
    ev += [_x(name, 'user_annotation', s + a, d)
           for name, (a, d) in SPANS.items()]
    kernels += [(st, s + launch, s + start, dur)
                for st, launch, start, dur in KERNELS]
  ev.append(_x('physics.kinematics', 'user_annotation', 285, 10))
  kernels += [('kinematics', 290, 300, 15), ('rewards', 750, 800, 10)]
  for i, (name, launch, start, dur) in enumerate(kernels):
    ev += [_x('cudaLaunchKernel', 'cuda_runtime', launch, 1, corr=i),
           _x(name, 'kernel', start, dur, corr=i)]
  return {'traceEvents': ev}


def record(**extra) -> dict:
  rec = trace.parse(synthetic_trace())
  rec.update(steps=2, num_envs=3, kind='NVIDIA H100 80GB HBM3',
             captures={}, **extra)
  return rec


def expected_ms(stage: str) -> float:
  dur = 2 * PER_STEP[stage] + (15 if stage == 'kinematics' else 0)
  return dur / 2 * 1e-3


# each new metric (both cells' forms) on record(counters=COUNTERS)
NEW = {f'{st}_ms': expected_ms(st) for st in ('kinematics', 'dynamics',
                                              'constraint', 'sensor',
                                              'integrate')}
NEW.update(physics_idle_ms=112 / 2 * 1e-3, contacts_per_env=140 / 8,
           resets_per_step=3 / 2)
NAMES = [f'{m}.{c}' for m in NEW for c in ('train', 'play')]
COUNTERS = {'contacts_active': (140.0, 8, 4), 'resets': (3.0, 2, 2)}


def test_the_new_metrics_are_in_the_benchmark():
  per_layer = {m['name']: m for m in BENCH['per_layer']}
  for name in NAMES:
    m = per_layer[name]
    cell = 'g1_flat_train' if name.endswith('.train') else 'g1_rough_play'
    assert m['workloads'] == [cell]
    assert m['moves'] == ('train_env_steps_per_s' if cell == 'g1_flat_train'
                          else 'play_env_steps_per_s')


@pytest.mark.parametrize('stage', STAGES)
def test_each_stage_by_hand(stage):
  """Each stage's kernels over the two env-steps (the refresh's kernel in
  physics.kinematics too); collision and solve, whose entries lie inside
  their stage spans, read the same through the entry ranges."""
  rec = record()
  want = expected_ms(stage)
  assert program_spans.stage_ms(rec, stage) == pytest.approx(want)
  if stage in ('collision', 'solve'):
    assert readers.device_ms_per_step(rec, f'entry.{stage}') == \
        pytest.approx(want)


def test_the_stages_cover_the_physics_step():
  """The seven stages add up to the device time launched in physics.step
  and in the refresh's forward."""
  rec = record()
  total = sum(program_spans.stage_ms(rec, st) for st in STAGES)
  inside = readers.device_ms_per_step(rec, 'physics.step')
  assert inside == pytest.approx(sum(PER_STEP.values()) * 1e-3)
  assert total == pytest.approx(inside + 15 / 2 * 1e-3)


def test_physics_idle_by_hand():
  rec = record()
  assert program_spans.physics_idle_ms(rec) == pytest.approx(112 / 2 * 1e-3)
  assert trace.idle_gaps(rec)[0] == (0, 100)


@pytest.mark.parametrize('name', NAMES)
def test_every_new_metric_file_reads_the_synthetic_record(name):
  v = spec.metric_module(name).read(record(counters=dict(COUNTERS)))
  assert v == pytest.approx(NEW[name.rsplit('.', 1)[0]])


def test_absent_spans_and_counters_read_nothing():
  """No physics span (a program without spans), no device operation (the
  CPU), no counter (a record no live profile made, a program without
  counters): None."""
  bare = trace.parse({'traceEvents': [
      _x('bench.window', 'user_annotation', 0, 1000),
      _x('cudaLaunchKernel', 'cuda_runtime', 5, 1, corr=0),
      _x('k', 'kernel', 10, 5, corr=0)]})
  bare.update(steps=2, captures={})
  for st in STAGES:
    assert program_spans.stage_ms(bare, st) is None
  assert program_spans.physics_idle_ms(bare) is None
  cpu = record()
  cpu.update(ops=[], busy_s=0.0)
  assert program_spans.physics_idle_ms(cpu) is None
  assert program_spans.stage_ms(cpu, 'kinematics') is None
  for name in NAMES:
    assert spec.metric_module(name).read(bare) is None, name
    if name.startswith(('contacts_per_env', 'resets_per_step')):
      assert spec.metric_module(name).read(record()) is None, name


def test_a_live_record_takes_the_ports_counters_once(monkeypatch):
  """The first reader of a record that trace.profile made takes the port's
  counters and clears them; the next reads the record's copy. A program
  without the tracing module has none."""
  from mjlab_torch.utils import tracing
  tracing.reset_counters()
  with torch.profiler.profile():
    for n in (3, 5):
      tracing.count('contacts_active', torch.full((2,), n))
    tracing.count('resets', torch.tensor(4.0))
  rec = record(host_window_s=1e-3)
  assert program_spans.contacts_per_env(rec) == pytest.approx(16 / 4)
  assert tracing.counters() == {}
  assert program_spans.resets_per_step(rec) == pytest.approx(4.0)
  import mjlab_torch.utils
  monkeypatch.delattr(mjlab_torch.utils, 'tracing')
  monkeypatch.setitem(sys.modules, 'mjlab_torch.utils.tracing', None)
  assert program_spans.counters(record(host_window_s=1e-3)) == {}
