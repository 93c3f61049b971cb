"""Report on a NanGuard dump and replay it in MuJoCo's viewer.

Counterpart of mjlab_tpu/scripts/nan_viz.py. Loads `nan_dump_*.npz` and
prints, step by step, how many qpos and qvel values of one dumped env are
non-finite. Then it takes the compiled model beside the dump: `model.mjb`
(the guard writes it where mujoco can be imported) is replayed in MuJoCo's
native viewer, the dump's steps in a loop at `--fps`, where DISPLAY is
set; otherwise, or with only `model.npz` (a ModelArrays snapshot: a GPU
host's dump), the report is all. Returns the model file it took, or None.

    python -m mjlab_torch.scripts.nan_viz <dump.npz> [--model model.mjb]
        [--env-index 0] [--fps 10]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('dump', help='nan_dump_*.npz from NanGuard')
  p.add_argument('--model', default=None,
                 help='model.mjb or model.npz (default: beside the dump, '
                 'model.mjb where it exists)')
  p.add_argument('--env-index', type=int, default=0,
                 help='which dumped env to replay')
  p.add_argument('--fps', type=float, default=10.0)
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

  model_path = args.model
  if model_path is None:
    here = os.path.dirname(os.path.abspath(args.dump))
    model_path = os.path.join(here, 'model.mjb')
    if not os.path.exists(model_path):
      model_path = os.path.join(here, 'model.npz')
  if not os.path.exists(model_path):
    print(f'no model at {model_path}; headless report only')
    return None
  if model_path.endswith('.npz'):
    from mjlab_torch.physics.io import ModelArrays
    nq = ModelArrays.load(model_path).nq
  else:
    import mujoco
    m = mujoco.MjModel.from_binary_path(model_path)
    nq = m.nq
  if nq != qpos.shape[-1]:
    raise SystemExit(f'{model_path} has nq {nq}; the dump has '
                     f'{qpos.shape[-1]}')
  print(f'model {model_path} (nq {nq})')
  if model_path.endswith('.npz'):
    print('no model.mjb beside the dump (the guard writes it where mujoco '
          'can be imported); headless report only')
    return model_path
  if not os.environ.get('DISPLAY'):
    print('no $DISPLAY; headless report only')
    return model_path
  import time

  import mujoco.viewer
  d = mujoco.MjData(m)
  with mujoco.viewer.launch_passive(m, d) as viewer:
    t = 0
    while viewer.is_running():
      d.qpos[:] = np.nan_to_num(qpos[t % qpos.shape[0], e])
      mujoco.mj_forward(m, d)
      viewer.sync()
      time.sleep(1.0 / args.fps)
      t += 1
  return model_path


if __name__ == '__main__':
  main()
