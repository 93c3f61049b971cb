"""Report on a NanGuard dump.

Counterpart of mjlab_tpu/scripts/nan_viz.py. Loads `nan_dump_*.npz` and
prints, step by step, how many qpos and qvel values of one dumped env are
non-finite. The JAX script then replays the dump in MuJoCo's viewer; the
port has no viewer yet (ROADMAP 12.10), so after the report it checks the
compiled model beside the dump (`model.npz`, a ModelArrays snapshot) and
stops.

    python -m mjlab_torch.scripts.nan_viz <dump.npz> [--model model.npz]
        [--env-index 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('dump', help='nan_dump_*.npz from NanGuard')
  p.add_argument('--model', default=None,
                 help='model.npz (default: beside the dump)')
  p.add_argument('--env-index', type=int, default=0,
                 help='which dumped env to report')
  args = p.parse_args(argv)

  blob = np.load(args.dump)
  qpos = blob['qpos']  # (T, E, nq)
  qvel = blob['qvel']
  steps = blob['steps']
  bad_ids = blob['bad_env_ids']
  e = args.env_index
  print(f'dump: {qpos.shape[0]} steps, envs {bad_ids.tolist()} '
        f'(replaying slot {e} = env {bad_ids[e]})')

  for t in range(qpos.shape[0]):
    nq_bad = int(np.sum(~np.isfinite(qpos[t, e])))
    nv_bad = int(np.sum(~np.isfinite(qvel[t, e])))
    marker = ' <-- non-finite' if (nq_bad or nv_bad) else ''
    print(f'  step {int(steps[t])}: qpos nan/inf={nq_bad} '
          f'qvel nan/inf={nv_bad}{marker}')

  model_path = args.model or os.path.join(
      os.path.dirname(os.path.abspath(args.dump)), 'model.npz')
  if not os.path.exists(model_path):
    print(f'no model at {model_path}; headless report only')
    return
  from mjlab_torch.physics.io import ModelArrays
  m = ModelArrays.load(model_path)
  if m.nq != qpos.shape[-1]:
    raise SystemExit(f'{model_path} has nq {m.nq}; the dump has '
                     f'{qpos.shape[-1]}')
  print('no viewer in mjlab_torch yet (ROADMAP 12.10); headless report '
        'only')


if __name__ == '__main__':
  main()
