"""The end-of-run gates of chip_smoke.py's phase 14a at several depths, on
the CPU.

Phase 14a steps each oracle model whose equality rows the plain Newton
solves (connect, weld, joint, the four-bar, the mocap weld) from
`chip_smoke.oracle_states` at 4096 envs, and gates the largest equality
residual at the end of the run (ORACLE_RESIDUAL) and the welded box's
distance from the mocap target (ORACLE_LAG). This tool replays the same
seeded states in float32 on the CPU's plain path and prints both after
each depth in --marks, so a depth can be chosen before a run on the card.

    python tools/oracle_residual_depth.py [--envs 4096] [--marks 40,60,100]

Takes ~15 minutes on two CPU threads at 4096 envs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

PLAIN_MODELS = ('connect', 'weld', 'joint', 'fourbar', 'mocap_weld')


def gates_by_depth(name: str, envs: int, marks) -> dict:
  """{depth: (max |equality residual|, the welded box's largest distance
  from where the weld holds it or None, every qpos finite)}."""
  import chip_smoke as cs
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import oracle_models as om
  from mjlab_torch.physics import constraint, pipeline, smooth

  m = phys.put_model(om.oracle_arrays(name), device='cpu')
  s = m.stat
  qpos, qvel, ctrl = cs.oracle_states(torch, m, name, envs, seed=14)
  d = phys.make_batched_data(m, envs, device='cpu').replace(
      qpos=qpos, qvel=qvel, ctrl=ctrl)
  out = {}
  for t in range(max(marks)):
    if s.nmocap:
      d = d.replace(mocap_pos=cs.mocap_targets(torch, t, envs, 'cpu'))
    d = phys.step(m, d)
    if t + 1 not in marks:
      continue
    end = constraint.make_efc(m, smooth.fwd_smooth(m, smooth.actuation(
        m, pipeline.fwd_velocity(m, pipeline.fwd_position(m, d)))))
    lag = None
    if s.nmocap:  # as phase 14a measures it
      offset = m.qpos0[:3] - m.body_pos[int(np.nonzero(
          s.body_mocapid >= 0)[0][0])]
      target = cs.mocap_targets(torch, t, envs, 'cpu')[:, 0]
      lag = float((d.qpos[:, :3] - target - offset).norm(dim=-1).max())
    out[t + 1] = (float(end['e_pos'].abs().max()), lag,
                  bool(torch.isfinite(d.qpos).all()))
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__,
                              formatter_class=argparse.RawTextHelpFormatter)
  p.add_argument('--envs', type=int, default=4096)
  p.add_argument('--marks', default='40,50,60,70,80,100')
  p.add_argument('--threads', type=int, default=2)
  args = p.parse_args(argv)
  torch.set_num_threads(args.threads)
  marks = tuple(int(x) for x in args.marks.split(','))
  for name in PLAIN_MODELS:
    t0 = time.perf_counter()
    rows = gates_by_depth(name, args.envs, marks)
    print(f'{name} ({time.perf_counter() - t0:.0f} s): ' + ', '.join(
        f'{k} substeps: residual {r:.3e}'
        + ('' if lag is None else f', lag {lag:.4f} m')
        + ('' if fin else ', NOT FINITE') for k, (r, lag, fin) in
        rows.items()), flush=True)


if __name__ == '__main__':
  main()
