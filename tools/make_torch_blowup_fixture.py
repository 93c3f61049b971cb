"""Distill the round-4 float32 blowup into a solver-level fixture, with the
port.

Counterpart of tools/make_blowup_fixture.py, on mjlab_torch alone. The
forensic ring artifacts/blowups_r4/blowup_ring.npz holds 40 pre-explosion
env states of a G1 flat velocity training. With the pre-fix unguarded
line-search polish (`physics/solver.py:UNSAFE_LS_POLISH`), ring row 38
blows up at the 5th substep (max |qvel| 111.1, artifacts/blowups_r4/
replay_report.txt); row 0 is the hottest env that does not. This tool
replays rows (38, 0) through the port's G1 flat env path (the action
applied, then substeps 1-4 under the unguarded polish, which the biting
state needs: the two polishes drift apart in the last float over the
benign substeps), and freezes the Newton solver's inputs of substep 5 in
the format of tests/data/blowup_ls_fixture.npz (which the JAX package's
tool wrote): the arguments of `solver.newton_plain`, the velocity, the
smooth force and implicitfast's velocity derivative to finish the
substep, and the solver's parameters.

    python tools/make_torch_blowup_fixture.py [--out PATH] [--device cpu]

writes PATH (default build/blowup_ls_fixture_torch.npz) in float32. Runs on
the GPU unless `--device cpu` is given; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

RING = os.path.join(ROOT, 'artifacts', 'blowups_r4', 'blowup_ring.npz')
OUT = os.path.join(ROOT, 'build', 'blowup_ls_fixture_torch.npz')
TASK = 'Mjlab-Velocity-Flat-Unitree-G1'
# ring row 38 is the biting env; row 0 the hottest benign one
ROWS = (38, 0)
BITE_SUBSTEP = 5
ARG_KEYS = ('M', 'a0', 'ws', 'cJ', 'c_aref', 'cD', 'c_act', 'l_sign',
            'l_aref', 'lD', 'l_act', 'f_aref', 'fD', 'floss', 'f_act')
STATE_KEYS = ('qpos', 'qvel', 'ctrl', 'qacc_warmstart', 'xfrc_applied',
              'qfrc_applied', 'time')


def fixture(ring_path: str = RING, device: str = 'cuda') -> dict:
  """The fixture's arrays, by the keys of tests/data/blowup_ls_fixture.npz."""
  from mjlab_torch.physics import constraint, pipeline, smooth, solver
  from mjlab_torch.tasks import registry

  sel = np.asarray(ROWS)
  with np.load(ring_path, allow_pickle=False) as z:
    ring = {k: z[k][sel] for k in STATE_KEYS + ('processed_action',
                                                'model_geom_friction')}
  env = registry.make(TASK, device=device,
                      **{'scene.num_envs': len(sel)})
  t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=env.device)
  state, _ = env.init_state(0)
  state = state.replace(
      data=state.data.replace(**{k: t(ring[k]) for k in STATE_KEYS}),
      model=state.model.replace(
          geom_friction=t(ring['model_geom_friction'])))
  ctx = env._make_ctx(state)
  data = env.action_manager.apply(ctx, state.data,
                                  t(ring['processed_action']))
  model = state.model
  solver.UNSAFE_LS_POLISH = True
  try:
    for _ in range(BITE_SUBSTEP - 1):
      data = pipeline.step(model, data)
  finally:
    solver.UNSAFE_LS_POLISH = False

  # the forward pipeline up to the solve, and what the solve is handed
  d5 = pipeline.fwd_velocity(model, pipeline.fwd_position(model, data))
  d5 = smooth.fwd_smooth(model, smooth.actuation(model, d5))
  efc = constraint.make_efc(model, d5)
  lay = constraint.efc_layout(model.stat)
  assert lay.ne == 0 and lay.nlt == 0, 'the fixture is of the ne = 0 path'
  args = solver.newton_args(d5, efc)
  deriv = model.dof_damping - pipeline._actuator_vel_deriv(model, d5)
  iterations, ls_polish, ldof, grad_th = solver.solver_params(model.stat)
  n = lambda x: x.detach().cpu().numpy()
  out = {k: n(a) for k, a in zip(ARG_KEYS, args)}
  out.update(
      qvel=n(d5.qvel), qfrc_smooth=n(d5.qfrc_smooth),
      deriv=n(deriv.expand_as(d5.qvel)),
      dt=np.float32(float(model.opt.timestep)),
      iterations=np.int32(iterations), ls_polish=np.int32(ls_polish),
      grad_th=np.float32(grad_th), ldof=np.asarray(ldof, np.int32),
      ring_rows=np.asarray(ROWS, np.int32),
      bite_substep=np.int32(BITE_SUBSTEP),
      qvel_limit=np.float32(env.cfg.sanity_qvel_limit))
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__,
                              formatter_class=argparse.RawTextHelpFormatter)
  p.add_argument('--ring', default=RING)
  p.add_argument('--out', default=OUT)
  p.add_argument('--device', default='cuda')
  args = p.parse_args(argv)
  out = fixture(args.ring, args.device)
  os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
  np.savez_compressed(args.out, **out)
  print(f'wrote {args.out}: rows={ROWS} substep={BITE_SUBSTEP} '
        f'ncr={out["cJ"].shape[1]} nv={out["qvel"].shape[-1]} '
        f'iters={int(out["iterations"])} ls_polish={int(out["ls_polish"])}')


if __name__ == '__main__':
  main()
