"""The harness on the CPU at a tiny size: every cell of BENCHMARK.json runs
end to end against the frozen reference and comes out correct; a changed
pinned file stops the reference; a cell and a per-layer metric added as
files alone are found and run; the check for JAX modules compares whole
top-level names."""

import json
import shutil
import sys

import pytest
import torch

from benchmark.lib import check, harness, spec
from benchmark.tests import tiny

BENCH = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.fixture(autouse=True)
def _threads():
  n = torch.get_num_threads()
  torch.set_num_threads(2)
  yield
  torch.set_num_threads(n)


@pytest.mark.parametrize('name', CELLS)
def test_cell_runs_and_matches_reference(name):
  cell, overrides = tiny.shrink(spec.load_cell(name))
  res = harness.run_cell(cell, 3_000_000_019, 0.5, traced=False,
                         device='cpu', overrides=overrides)
  assert res['correct'], res['checks']
  assert set(res['metrics']) == {m['name'] for m in cell.end_to_end}
  assert list(res)[-1] == 'checks'
  for c in res['checks'].values():
    assert c['value'] <= c['limit']


@pytest.mark.parametrize('name', CELLS)
def test_traced_run_reads_no_device_metric_on_the_cpu(name):
  """The CPU trace has no device operation: every device metric is left
  out rather than read as 0, and the StageClock's spans still read."""
  cell, overrides = tiny.shrink(spec.load_cell(name))
  res = harness.run_cell(cell, 5, 0.2, traced=True, device='cpu',
                         overrides=overrides)
  assert res['correct'], res['checks']
  device_metrics = {m['name'] for m in cell.per_layer
                    if m['source'] == 'device_trace'}
  assert not device_metrics & set(res['metrics'])
  assert res['device']['busy_s'] == 0
  assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}


@pytest.mark.parametrize('name', CELLS)
def test_a_changed_pinned_file_stops_the_reference(name):
  """Each cell pins the raw files its reference reads; a digest that no
  longer matches raises before the reference is built."""
  cell, overrides = tiny.shrink(spec.load_cell(name))
  pinned = {**cell.config.get('pinned', {}), **cell.traffic.get('pinned', {})}
  assert pinned, 'the cell pins no file'
  for rel, digest in pinned.items():
    assert (spec.ROOT / rel).is_file()
    cell.config['pinned'] = {rel: '0' * 64}
    with pytest.raises(ValueError, match='sha256'):
      check.Reference(cell, 7, 'cpu', overrides)


def test_a_cell_and_a_metric_added_as_files(tmp_path):
  """A later change adds `g1_flat_play` and a metric by new files and
  BENCHMARK.json entries alone; nothing existing is edited."""
  bench = json.loads(json.dumps(BENCH))
  bench['workloads'].append({
      'name': 'g1_flat_play', 'config': 'g1_flat_velocity',
      'traffic': 'shipped_actor_16384', 'chips': 1,
      'why': 'the shipped flat actor at 16384 envs'})
  for m in bench['end_to_end']:
    if m['name'].startswith('play_'):
      m['workloads'].append('g1_flat_play')
  bench['per_layer'].append({
      'name': 'window_ms.play', 'unit': 'ms', 'better': 'lower',
      'source': 'device_trace', 'layer': 'device',
      'moves': 'play_env_steps_per_s', 'workloads': ['g1_flat_play']})
  (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
  workloads = tmp_path / 'workloads'
  shutil.copytree(spec.WORKLOADS, workloads)
  traffic = json.loads((workloads / 'g1_rough_play.json').read_text())
  traffic.update(traffic='shipped_actor_16384',
                 env_overrides={'scene.num_envs': 16384})
  (workloads / 'g1_flat_play.json').write_text(json.dumps(traffic))
  metrics = tmp_path / 'metrics'
  shutil.copytree(spec.METRICS, metrics)
  (metrics / 'window_ms.play.py').write_text(
      'def read(rec):\n  return rec["host_window_s"] * 1e3\n')
  cell = spec.load_cell('g1_flat_play', tmp_path / 'BENCHMARK.json',
                        workloads, metrics)
  assert cell.config['name'] == 'g1_flat_velocity'
  assert {m['name'] for m in cell.end_to_end} == {
      'play_env_steps_per_s', 'play_step_ms_p95', 'setup_s'}
  assert 'window_ms.play' in {m['name'] for m in cell.per_layer}
  cell, overrides = tiny.shrink(cell)
  res = harness.run_cell(cell, 11, 0.2, traced=True, device='cpu',
                         overrides=overrides)
  assert res['correct'], res['checks']
  assert res['metrics']['window_ms.play']['value'] > 0


@pytest.mark.parametrize('name,found', [
    ('jax', True), ('jax.numpy', True), ('jaxlib.xla_client', True),
    ('flax.linen', True), ('mjlab_tpu', True), ('mjlab_tpu.physics', True),
    ('jaxtyping', False), ('mjlab_tpu_extra', False),
    ('mjlab_torch.physics', False), ('jax_fake_suffix', False)])
def test_forbidden_modules_compare_whole_names(monkeypatch, name, found):
  for m in list(sys.modules):
    if m.split('.')[0] in harness.FORBIDDEN:
      monkeypatch.delitem(sys.modules, m)
  monkeypatch.setitem(sys.modules, name, object())
  assert (name in harness.forbidden_modules()) is found


def test_main_refuses_without_a_card(monkeypatch, capsys):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert harness.main(['--workload', CELLS[0], '--seed', '1', '--seconds',
                       '1'], 0.0) != 0
  out = capsys.readouterr()
  assert out.out == ''
