"""Does the JAX package reach the port's foot penetration on rough terrain?

On the card the port's G1 rough env reaches 3.6-3.8 cm between a foot and
a flat tread under the shipped G1 flat actor. This runs
`Mjlab-Velocity-Rough-Unitree-G1` (the registered terrain) in both
packages on the CPU in float32 from one state: the JAX env is reset, its
state is carried into the port's env (the same compiled MjModel), and each
package then steps its own env for `--steps` env-steps under the shipped
flat actor (the port's copy of it, evaluated on each package's own
observations). Every physics substep records, for each env, the deepest
active heightfield contact (the port's `pipeline.step` wrapped in Python,
the JAX one under `jax.debug.callback`). Printed for each package: the
share of (env, substep) pairs with an active heightfield contact, the
penetration (-dist) quantiles over them, the deepest, the pairs deeper
than 1, 2 and 3 cm, and the resets.

Agreement criterion (fixed before the first run): the packages agree when
the active share differs by at most 0.05, each of the 50, 90 and 99 %
quantiles by at most max(2 mm, 20 % of the JAX one), and the deepest by at
most max(5 mm, 25 % of the JAX one). The trajectories part after a few
env-steps (float32 roundoff in contact dynamics), so distributions are
compared, not states.

    python tools/rough_penetration_compare.py [--envs 48] [--steps 150]
        [--seed 0] [--out chiprun_out/rough_penetration.json]

CPU only, one intra-op thread; the JAX env's compile takes a few minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))
os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ.setdefault('OMP_NUM_THREADS', '1')

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

TASK = 'Mjlab-Velocity-Rough-Unitree-G1'
QUANTILES = (0.5, 0.9, 0.99)
DEPTHS = (0.01, 0.02, 0.03)  # m
FAR = 1e9


def summary(deepest, resets: int) -> dict:
  """`deepest` (substeps, envs) of dist, FAR where no heightfield contact
  was active."""
  import numpy as np
  active = deepest < FAR / 2
  pen = -deepest[active]
  out = {'pairs': int(deepest.size), 'active_share': float(active.mean()),
         'resets': resets,
         'deepest_m': float(pen.max()) if pen.size else 0.0,
         'quantiles_m': {str(q): float(np.quantile(pen, q)) if pen.size
                         else 0.0 for q in QUANTILES},
         'deeper_than': {str(d): int((pen > d).sum()) for d in DEPTHS}}
  per_sub = np.where(active, -deepest, -np.inf).max(axis=1)
  out['substep_max_quantiles_m'] = {
      str(q): float(np.quantile(per_sub[np.isfinite(per_sub)], q))
      for q in QUANTILES} if np.isfinite(per_sub).any() else {}
  return out


def verdict(j: dict, p: dict) -> dict:
  checks = {'active_share': abs(p['active_share'] - j['active_share'])
            <= 0.05}
  for q in QUANTILES:
    a, b = j['quantiles_m'][str(q)], p['quantiles_m'][str(q)]
    checks[f'q{q}'] = abs(b - a) <= max(0.002, 0.2 * a)
  a, b = j['deepest_m'], p['deepest_m']
  checks['deepest'] = abs(b - a) <= max(0.005, 0.25 * a)
  return {'agree': all(checks.values()), 'checks': checks}


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--envs', type=int, default=48)
  p.add_argument('--steps', type=int, default=150)
  p.add_argument('--seed', type=int, default=0)
  p.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                'rough_penetration.json'))
  args = p.parse_args()
  import jax.numpy as jnp
  import numpy as np
  import torch
  torch.set_num_threads(1)

  from chip_smoke import hfield_groups
  from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
  from mjlab_torch.envs.io import env_state_from_numpy
  from mjlab_torch.physics import pipeline as tpipe
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.tasks import registry as treg
  from mjlab_tpu.physics import pipeline as jpipe
  from mjlab_tpu.tasks import registry as jreg
  from torch_parity import env_state_leaves

  n = args.envs
  t0 = time.time()
  # the port's static pair table names the heightfield slots, which both
  # engines order alike
  jcfg = jreg.load_cfg(TASK)
  jcfg.scene.num_envs = n
  jcfg.seed = args.seed
  tcfg = treg.load_cfg(TASK)
  tcfg.scene.num_envs = n
  tcfg.seed = args.seed
  hf_np = None
  jrec = []

  def record(dist):
    jrec.append(float(dist))

  plain_jstep = jpipe.step

  def jstep(m, d):
    out = plain_jstep(m, d)
    c = out.contact
    on = (c.dist < c.includemargin) & jnp.asarray(hf_np)
    jax.debug.callback(record, jnp.min(jnp.where(on, c.dist, FAR)))
    return out

  # the JAX env's build vmaps pipeline.step: build it with the recorder in
  # (it is traced, and reads the heightfield slots, at the first step)
  jpipe.step = jstep
  try:
    jenv = jreg.make(TASK, cfg=jcfg)
  finally:
    jpipe.step = plain_jstep
  tenv = treg.make(TASK, cfg=tcfg, device='cpu',
                   mj_model=jenv.scene.mj_model)
  tenv.reset()
  hf_np = np.zeros(tenv.state.data.contact.dist.shape[1], bool)
  for first, cnt in hfield_groups(tenv.model.stat).values():
    hf_np[first:first + cnt] = True
  actor = load_actor(G1_FLAT_POLICY, device='cpu')
  print(f'built both envs ({n} envs) in {time.time() - t0:.0f} s',
        flush=True)

  # ---- one state: the JAX env's reset, carried into the port's -----------
  jstate, jobs = jenv.init_state(args.seed)
  tenv._state = env_state_from_numpy(
      env_state_leaves(jstate, tuple(tenv.per_env_fields)), tenv)
  tobs = {k: torch.as_tensor(np.array(v)) for k, v in jobs.items()}
  jstep_fn = jax.jit(jenv.step_fn)

  # ---- the JAX leg ----------------------------------------------------------
  t0 = time.time()
  resets = 0
  for _ in range(args.steps):
    with torch.no_grad():
      act = actor(torch.as_tensor(np.array(jobs["policy"])))
    jstate, (jobs, _, _, _, extras) = jstep_fn(jstate, jnp.asarray(
        act.numpy()))
    resets += int(extras['reset_count'])
  jax.effects_barrier()
  subs = len(jrec) // n
  jdeep = np.asarray(jrec[:subs * n], np.float64).reshape(subs, n)
  jsum = summary(jdeep, resets)
  jsum['seconds'] = time.time() - t0

  # ---- the port leg ---------------------------------------------------------
  trec = []
  hf = torch.as_tensor(hf_np)
  plain_tstep = tpipe.step

  def tstep(m, d):
    out = plain_tstep(m, d)
    c = out.contact
    on = (c.dist < c.includemargin) & hf
    trec.append(torch.where(on, c.dist, FAR).amin(-1).double().numpy())
    return out

  t0 = time.time()
  resets = 0
  tpipe.step = tstep
  try:
    for _ in range(args.steps):
      with torch.no_grad():
        obs, _, _, _, extras = tenv.step(actor(tobs['policy']))
      tobs = obs
      resets += int(extras['reset_count'])
  finally:
    tpipe.step = plain_tstep
  tsum = summary(np.stack(trec), resets)
  tsum['seconds'] = time.time() - t0

  v = verdict(jsum, tsum)
  for name, r in (('mjlab_tpu', jsum), ('mjlab_torch', tsum)):
    q = r['quantiles_m']
    print(f'{name}: {r["pairs"]} (substep, env) pairs, active share '
          f'{r["active_share"]:.4f}; penetration 50/90/99 % '
          f'{q["0.5"] * 100:.3f}/{q["0.9"] * 100:.3f}/{q["0.99"] * 100:.3f}'
          f' cm, deepest {r["deepest_m"] * 100:.3f} cm; deeper than 1/2/3 '
          f'cm {list(r["deeper_than"].values())}; resets {r["resets"]}; '
          f'{r["seconds"]:.0f} s', flush=True)
  print(f'checks {v["checks"]}; verdict: '
        f'{"the packages agree" if v["agree"] else "they disagree"}')
  os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
  with open(args.out, 'w') as f:
    json.dump({'envs': n, 'steps': args.steps, 'seed': args.seed,
               'jax': jsum, 'port': tsum, 'verdict': v}, f, indent=1)


if __name__ == '__main__':
  main()
