"""Does G1 flat train from scratch in the port as it does in the JAX package?

Both learners start from one state: for each seed the JAX package's PPO
initializes its learner (`init_state(seed)`), and the port's takes the same
parameters, Adam state, normalizers and learning rate through
`rl/ppo.py:train_state_from_numpy`. Each package then runs its own env of
`Mjlab-Velocity-Flat-Unitree-G1` (the same compiled MjModel, float32, on the
CPU, reset from its own random stream) and its own learner for `--iters`
iterations at `--envs` envs with the registered agent cfg. The two random
streams differ, so the runs are compared as distributions over the seeds,
per iteration: the mean episode length of the envs that reset, the share
of resets that were `fell_over`, and PPO's kl.

Agreement criterion (fixed before the first run): the iterations are cut
into blocks of BLOCK; in each block every seed gives each metric's mean
over the block's iterations; the packages agree on a metric in a block
when the two seed-means differ by at most 3 standard errors of that
difference (sqrt(var_port / S + var_jax / S), the seeds' sample variances)
plus the metric's floor: FLOORS (episode length relative to the JAX mean,
the fell_over share absolute, kl on log10). They agree when every metric
agrees in every block. A disagreement is a fault of the port, to be found.

    python tools/early_training_compare.py [--envs 48] [--iters 20]
        [--seeds 0 1 2 3 4 5 6 7] [--jobs 4]
        [--out chiprun_out/early_training.json]

Each seed runs in a process of its own (`--jobs` at a time, one intra-op
thread each): the JAX leg (its compile takes a few minutes), then the port
leg; the defaults take about 26 minutes on 4 cores. Fewer seeds
under-state the spread: one package's per-seed means span 33-52
env-steps over seeds 0-7. CPU only; prints each seed's table and the
verdict, and writes every number to `--out`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = 'Mjlab-Velocity-Flat-Unitree-G1'
METRICS = ('mean_episode_length', 'fell_over_share', 'kl')
BLOCK = 5
# the floor each metric's difference may take beyond 3 standard errors
FLOORS = {'mean_episode_length': ('relative', 0.10),
          'fell_over_share': ('absolute', 0.10),
          'kl': ('log10', 0.5)}


def _row(logs: dict) -> dict:
  resets = logs['resets']
  fell = logs.get('Episode_Termination/fell_over', 0.0)
  return {'mean_episode_length': logs['mean_episode_length'],
          'fell_over_share': fell / resets if resets > 0 else float('nan'),
          'kl': logs['kl'], 'resets': resets, 'fell_over': fell}


def run_seed(seed: int, envs: int, iters: int) -> dict:
  """Both legs of one seed, in this process."""
  os.environ['JAX_PLATFORMS'] = 'cpu'
  import jax
  jax.config.update('jax_platforms', 'cpu')
  import numpy as np
  import torch
  torch.set_num_threads(1)

  from mjlab_tpu.rl.runner import make_runner as jmake_runner
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.rl import ppo as tppo
  from mjlab_torch.rl.runner import make_runner as tmake_runner
  from mjlab_torch.tasks import registry as treg

  out = {'seed': seed, 'jax': [], 'port': []}
  # ---- JAX leg ----------------------------------------------------------
  t0 = time.time()
  jcfg = jreg.load_cfg(TASK)
  jcfg.scene.num_envs = envs
  jcfg.seed = seed
  jagent = jreg.load_cfg(TASK, 'rl_cfg_entry_point')
  jagent.seed = seed
  jenv = jreg.make(TASK, cfg=jcfg)
  jrun = jmake_runner(jenv, jagent)
  jts = jrun.alg.init_state(seed)
  start = jax.device_get(jts)
  for _ in range(iters):
    jts, logs = jrun.alg.learn_iteration(jts)
    logs.pop('_qpos_env0', None)
    out['jax'].append(_row({k: float(np.asarray(v))
                            for k, v in logs.items()}))
  out['jax_s'] = time.time() - t0

  # ---- port leg, from the JAX learner's initial state ---------------------
  t0 = time.time()
  tcfg = treg.load_cfg(TASK)
  tcfg.scene.num_envs = envs
  tcfg.seed = seed
  tagent = treg.load_cfg(TASK, 'rl_cfg_entry_point')
  tagent.seed = seed
  tagent.device = 'cpu'
  tenv = treg.make(TASK, cfg=tcfg, device='cpu',
                   mj_model=jenv.scene.mj_model)
  trun = tmake_runner(tenv, tagent)
  tts = tppo.train_state_from_numpy(trun.alg, start)
  for _ in range(iters):
    tts, logs = trun.alg.learn_iteration(tts)
    logs.pop('_clock')
    logs.pop('_qpos_env0', None)
    out['port'].append(_row({k: float(v) for k, v in logs.items()}))
  out['port_s'] = time.time() - t0
  return out


def _block_stats(runs: 'list[list[dict]]', metric: str, lo: int, hi: int):
  """Per seed, the metric's mean over iterations [lo, hi) (NaNs, the
  iterations without a reset, left out); then the seeds' mean and sample
  variance, and the number of seeds."""
  vals = []
  for rows in runs:
    xs = [r[metric] for r in rows[lo:hi] if not math.isnan(r[metric])]
    if metric == 'kl':
      xs = [math.log10(max(x, 1e-12)) for x in xs]
    if xs:
      vals.append(sum(xs) / len(xs))
  n = len(vals)
  mean = sum(vals) / n if n else float('nan')
  var = sum((v - mean) ** 2 for v in vals) / (n - 1) if n > 1 else 0.0
  return mean, var, n


def verdict(results: 'list[dict]', iters: int) -> dict:
  """The agreement criterion of the module's docstring, block by block."""
  blocks = []
  ok = True
  for lo in range(0, iters, BLOCK):
    hi = min(lo + BLOCK, iters)
    for metric in METRICS:
      jm, jv, jn = _block_stats([r['jax'] for r in results], metric, lo, hi)
      pm, pv, pn = _block_stats([r['port'] for r in results], metric, lo, hi)
      kind, floor = FLOORS[metric]
      if kind == 'relative':
        floor = floor * abs(jm)
      se = math.sqrt(pv / max(pn, 1) + jv / max(jn, 1))
      diff = pm - jm
      agree = (not math.isnan(diff)) and abs(diff) <= 3 * se + floor
      ok &= agree
      blocks.append({'iterations': [lo + 1, hi], 'metric': metric,
                     'jax_mean': jm, 'port_mean': pm, 'diff': diff,
                     'allowed': 3 * se + floor, 'agree': agree})
  return {'agree': ok, 'blocks': blocks}


def main() -> None:
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--envs', type=int, default=48)
  p.add_argument('--iters', type=int, default=20)
  p.add_argument('--seeds', type=int, nargs='+', default=list(range(8)))
  p.add_argument('--jobs', type=int, default=4)
  p.add_argument('--out', default=os.path.join(ROOT, 'chiprun_out',
                                                'early_training.json'))
  p.add_argument('--one-seed', type=int, default=None,
                 help=argparse.SUPPRESS)  # a worker: one seed, JSON out
  args = p.parse_args()
  if args.one_seed is not None:
    print(json.dumps(run_seed(args.one_seed, args.envs, args.iters)))
    return

  env = {**os.environ, 'OMP_NUM_THREADS': '1', 'PYTHONPATH': ROOT,
         'XLA_FLAGS': '--xla_cpu_multi_thread_eigen=false '
                      'intra_op_parallelism_threads=1'}
  t0 = time.time()
  results, pending = [], list(args.seeds)
  running = []
  while pending or running:
    while pending and len(running) < args.jobs:
      s = pending.pop(0)
      cmd = [sys.executable, os.path.abspath(__file__), '--one-seed', str(s),
             '--envs', str(args.envs), '--iters', str(args.iters)]
      running.append((s, subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                          text=True)))
    s, proc = running.pop(0)
    stdout, _ = proc.communicate()
    if proc.returncode:
      sys.exit(f'seed {s} failed ({proc.returncode})')
    results.append(json.loads(stdout.strip().splitlines()[-1]))
  results.sort(key=lambda r: r['seed'])

  for r in results:
    print(f'seed {r["seed"]}: JAX leg {r["jax_s"]:.0f} s, port leg '
          f'{r["port_s"]:.0f} s')
    print('  it | ep_len JAX  port | fell_over/resets JAX  port | kl JAX  '
          'port')
    for i, (j, t) in enumerate(zip(r['jax'], r['port'])):
      print(f'  {i + 1:2d} | {j["mean_episode_length"]:6.2f} '
            f'{t["mean_episode_length"]:6.2f} | {j["fell_over_share"]:5.3f} '
            f'{t["fell_over_share"]:5.3f} | {j["kl"]:.4g} {t["kl"]:.4g}')
  v = verdict(results, args.iters)
  for b in v['blocks']:
    print(f'iterations {b["iterations"][0]}-{b["iterations"][1]} '
          f'{b["metric"]}: JAX {b["jax_mean"]:.4g}, port '
          f'{b["port_mean"]:.4g}, |diff| {abs(b["diff"]):.4g} allowed '
          f'{b["allowed"]:.4g}: {"agree" if b["agree"] else "DISAGREE"}')
  print(f'verdict: {"the packages agree" if v["agree"] else "they disagree"}'
        f' ({len(results)} seeds, {args.envs} envs, {args.iters} '
        f'iterations, {time.time() - t0:.0f} s)')
  os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
  with open(args.out, 'w') as f:
    json.dump({'envs': args.envs, 'iters': args.iters, 'results': results,
               'verdict': v}, f, indent=1)


if __name__ == '__main__':
  main()
