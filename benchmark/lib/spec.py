"""What a cell is, read from `BENCHMARK.json` and the files it names.

A cell (`workloads[]` entry) names a configuration (`configs[]`, its file
under benchmark/configs/) and a traffic mix, whose parameters are
benchmark/workloads/<cell>.json. The end-to-end metrics it reports are those
of `end_to_end` whose `workloads` list names it (or that have no list); its
per-layer metrics, those of `per_layer` that name it the same way. Each
per-layer metric is read by benchmark/metrics/<name>.py. Nothing here knows
a cell, a configuration or a metric by name: a new one is new files and
new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
WORKLOADS = BENCH / 'workloads'
METRICS = BENCH / 'metrics'


@dataclasses.dataclass
class Cell:
  name: str
  chips: int
  config: dict  # the configuration file's contents
  traffic: dict  # benchmark/workloads/<cell>.json
  end_to_end: list  # BENCHMARK.json entries
  per_layer: list
  metrics_dir: Path = METRICS


def _for_cell(entries: list, cell: str) -> list:
  return [e for e in entries
          if 'workloads' not in e or cell in e['workloads']]


def load_cell(name: str, bench_file: 'Path | None' = None,
              workloads: Path = WORKLOADS, metrics: Path = METRICS) -> Cell:
  """The cell `name` of `bench_file` (the repo's BENCHMARK.json), its
  traffic from `workloads`/<name>.json and its readers in `metrics`."""
  bench = json.loads((bench_file or ROOT / 'BENCHMARK.json').read_text())
  cells = {w['name']: w for w in bench['workloads']}
  if name not in cells:
    raise KeyError(f'no workload {name!r} in BENCHMARK.json; have '
                   f'{sorted(cells)}')
  w = cells[name]
  configs = {c['name']: c for c in bench['configs']}
  config = json.loads((ROOT / configs[w['config']]['file']).read_text())
  traffic = json.loads((workloads / f'{name}.json').read_text())
  if traffic.get('traffic') != w['traffic']:
    raise ValueError(f'{workloads / name}.json is traffic '
                     f'{traffic.get("traffic")!r}, BENCHMARK.json says '
                     f'{w["traffic"]!r}')
  return Cell(name=name, chips=int(w['chips']), config=config,
              traffic=traffic,
              end_to_end=_for_cell(bench['end_to_end'], name),
              per_layer=_for_cell(bench['per_layer'], name),
              metrics_dir=metrics)


def metric_module(name: str, directory: Path = METRICS):
  """<directory>/<name>.py (benchmark/metrics/ by default) as a module;
  names may hold dots."""
  path = directory / f'{name}.py'
  spec = importlib.util.spec_from_file_location(
      'bench_metric_' + name.replace('.', '_').replace('-', '_'), path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod
