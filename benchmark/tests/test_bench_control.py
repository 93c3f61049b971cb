"""The control on the card: the reference computed in TF32 (the precision
below the configuration's float32 with TF32 off), put in the program's
place, has to come out not correct in every cell. Run at a size a test run
holds (1024 envs, a short window): below it, one contact flip among the
captured env-steps reads over the cell-size limit of
`physics.share_over_1e-3` (at 64 envs, 1 of 192 is 0.52 %). The cell-size
readings that set the limits come from benchmark/calibrate.py. Needs an
NVIDIA GPU; skips elsewhere.

    python3 -m pytest benchmark/tests/test_bench_control.py -q -m cuda
"""

import json

import pytest
import torch

from benchmark.lib import check, harness, spec

BENCH = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in BENCH['workloads']]


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU (the control is TF32)')
  return 'cuda'


@pytest.mark.cuda
@pytest.mark.parametrize('seed', [101, 202, 303])
@pytest.mark.parametrize('name', CELLS)
def test_tf32_control_is_not_correct(card, name, seed):
  cell = spec.load_cell(name)
  overrides = {'env': {'scene.num_envs': 1024}}
  res = harness.run_cell(cell, seed, 1.0, traced=False, device=card,
                         overrides=overrides, variants=('tf32',))
  assert res['correct'], res['checks']
  ok, _ = check.judge(res['variants']['tf32'], cell.traffic['limits'])
  assert not ok, res['variants']['tf32']
