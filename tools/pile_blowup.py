"""Finds the envs of the convex pile (asset_zoo/oracle_models.py) that leave
physical bounds, and what the colliders did to them.

Steps the pile from chip_smoke.py's seeded start states (pile_states, seed
15) for S substeps at N envs and marks an env as blown up once any |qvel|
passes 50 (m/s or rad/s) or any body lies more than 2 m from the grid's
centre. Prints, for each such env, the first substep of each bound and the
contacts active in the substep of its largest jump of |qvel| before it
(pile_states(..., 4096, 15)[env] restarts it on the CPU, in float64). On
the card it then holds K3 (ops/smooth_kernel.py) against its
plain version on the last state, output by output: each output's max
|kernel - plain| and max |plain|, the site frames included (the pile has
no site: the kernel leaves their padded row unwritten).

    python3 tools/pile_blowup.py [N] [S] [device] [dtype]
    # default 4096 60 cuda f32; on the CPU e.g. 16 60 cpu f64
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QVEL_BOUND = 50.0  # m/s or rad/s
POS_BOUND = 2.0  # m from the grid's centre


def main():
  import torch

  import chip_smoke as cs
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import oracle_models as om

  args = sys.argv[1:]
  n = int(args[0]) if args else 4096
  steps = int(args[1]) if len(args) > 1 else 60
  device = args[2] if len(args) > 2 else 'cuda'
  dtype = {'f32': torch.float32, 'f64': torch.float64}[
      args[3] if len(args) > 3 else 'f32']
  m = phys.put_model(om.oracle_arrays('convex_pile'), device=device,
                     dtype=dtype)
  qpos, qvel = cs.pile_states(torch, m, 4096, seed=15)
  qpos, qvel = qpos[:n].to(dtype), qvel[:n].to(dtype)
  d = phys.make_batched_data(m, n, device=device).replace(qpos=qpos,
                                                         qvel=qvel)
  centre = torch.tensor([0.0, 0.0, cs.PILE_BASE + cs.PILE_SPACING],
                        device=device, dtype=dtype)
  hist = {k: [] for k in ('qpos', 'qvel', 'dist')}
  t0 = time.perf_counter()
  for t in range(steps):
    d = phys.step(m, d)
    c = d.contact
    for k, v in (('qpos', d.qpos), ('qvel', d.qvel),
                 ('dist', c.dist - c.includemargin)):
      hist[k].append(v.clone())
  if device == 'cuda':
    torch.cuda.synchronize()
  print(f'{steps} substeps x {n} envs in {time.perf_counter() - t0:.1f} s',
        flush=True)
  h = {k: torch.stack(v, 1) for k, v in hist.items()}  # (n, steps, ...)
  vmax = h['qvel'].abs().amax(-1)
  body = h['qpos'].reshape(n, steps, 9, 7)[..., :3]
  far = (body - centre).norm(dim=-1).amax(-1)
  fast, out = vmax > QVEL_BOUND, far > POS_BOUND
  bad = torch.nonzero((fast | out).any(-1)).flatten()
  names = {}
  for key, (g1s, _, _, base, npts) in m.stat.pairs.groups.items():
    for j in range(len(g1s) * npts):
      names[base + j] = cs.pair_name(key)
  print(f'{len(bad)} of {n} envs leave the bounds (|qvel| > {QVEL_BOUND}, '
        f'a body > {POS_BOUND} m from the centre); max |qvel| over all envs '
        f'{float(vmax.max()):.4g}, largest distance {float(far.max()):.4g} m',
        flush=True)
  for e in bad.tolist():
    tv = int(fast[e].float().argmax()) if fast[e].any() else None
    tp = int(out[e].float().argmax()) if out[e].any() else None
    first = min(t for t in (tv, tp) if t is not None)
    # the largest jump of |qvel| up to the first crossing, and the contacts
    # active in the substep that made it
    jump = int((vmax[e, 1:first + 1] - vmax[e, :first]).argmax()) + 1 \
        if first else 0
    act = torch.nonzero(h['dist'][e, jump] < 0).flatten().tolist()
    print(f'env {e}: |qvel| bound at substep {tv}, position bound at {tp}; '
          f'max |qvel| {float(vmax[e].max()):.4g}; largest jump at substep '
          f'{jump}: {float(vmax[e, jump - 1]) if jump else 0.0:.4g} -> '
          f'{float(vmax[e, jump]):.4g}; contacts active then: '
          + ', '.join(f'{names[j]} slot {j} dist '
                      f'{float(h["dist"][e, jump, j]):.4g}' for j in act),
          flush=True)
  if device == 'cuda' and dtype == torch.float32:
    from mjlab_torch.ops import smooth_kernel as k_smooth
    from mjlab_torch.physics import smooth_fused
    kern = k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel)
    plain = smooth_fused.plain_all(m, d)
    print(f'K3 on the last state (nsite {m.stat.nsite}), output: max '
          '|kernel - plain|, max |plain|: ' + ', '.join(
              f'{k} {float((v - getattr(plain, k)).abs().max()):.4g}, '
              f'{float(getattr(plain, k).abs().max()):.4g}'
              for k, v in kern.items()), flush=True)


if __name__ == '__main__':
  main()
