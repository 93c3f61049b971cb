"""Replay the physics blowups that the MJLAB_BLOWUP_DUMP ring captured.

Counterpart of tools/blowup_replay.py for the port. Loads the
pre-substep snapshots that ManagerBasedRlEnv's forensic ring wrote
(`blowup_ring.npz`, or every `blowup_*.npz` of a directory) and re-runs
the exploding control step under controlled variants, to find what makes
a float32 blowup:

  env-f32   - the env's own substep path (the action applied every substep)
  eng-f32   - the engine's pipeline.step on a model built afresh from the
              task's compiled scene, float32 (sanity: must match env-f32)
  eng-f64   - the same in float64, always on the CPU (stable: precision)
  eng-it3x  - float32 with 3x Newton and 2x line-search iterations
              (stable: the solver stopped too early)
  eng-nocap - float32 without contact compaction (stable: compaction
              dropped a contact that bore load)

Per substep it reports max |qvel|, the active contacts of each compaction
pool against its cap, the deepest contact, and the Newton steps the
substep took before the freeze rule (counted on the plain solver), and
per variant the kernel launches (K2 runs only where the model fits its
shared memory: a variant on the plain solver says so) and how far the
first `decimation` substeps are from the captured `qvel_peaks`.

    python -m mjlab_torch.scripts.blowup_replay <dump dir or .npz> \\
        [--task Mjlab-Velocity-Flat-Unitree-G1] [--substeps 8] \\
        [--max-dumps 10] [--variants env-f32,eng-f32,...] [--device cuda]

Runs on the GPU unless `--device cpu` is given. The model comes from the
task's compiled scene (the committed snapshot): no `mujoco` is needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os

import numpy as np
import torch

from mjlab_torch.ops import LAUNCHES
from mjlab_torch.physics import constraint, pipeline, smooth, solver
from mjlab_torch.physics import io as phys_io
from mjlab_torch.tasks import registry

VARIANTS = ('env-f32', 'eng-f32', 'eng-f64', 'eng-it3x', 'eng-nocap')
STATE_KEYS = ('qpos', 'qvel', 'ctrl', 'qacc_warmstart', 'xfrc_applied',
              'qfrc_applied', 'time')


def _load_dumps(path: str, max_dumps: int):
  files = ([path] if os.path.isfile(path) else
           sorted(glob.glob(os.path.join(path, 'blowup_*.npz'))))[:max_dumps]
  if not files:
    raise SystemExit(f'no blowup_*.npz in {path}')
  dumps = []
  for f in files:
    with np.load(f, allow_pickle=False) as z:
      dumps.append({k: z[k] for k in z.files})
  return dumps, files


def _stack_dumps(dumps) -> dict:
  """Every dump's rows in one batch: the state, the processed action, the
  captured peaks (decimation, n) and every per-env `model_*` field."""
  keys = STATE_KEYS + ('processed_action', 'episode_length', 'env_ids')
  keys += tuple(k for k in dumps[0] if k.startswith('model_')
                and k != 'model_field_names')
  out = {k: np.concatenate([d[k] for d in dumps], axis=0)
         for k in keys if k in dumps[0]}
  out['qvel_peaks'] = np.concatenate([d['qvel_peaks'] for d in dumps],
                                     axis=1)
  return out


def _model_fields(batch: dict) -> dict:
  return {k[len('model_'):]: v for k, v in batch.items()
          if k.startswith('model_')}


def peaks_error(captured: np.ndarray, replayed: np.ndarray) -> float:
  """How far a replay's max |qvel| after each substep, (n, substeps), is
  from the captured peaks, (decimation, n): the largest difference over
  the first `decimation` substeps, over (1 + the largest captured finite
  peak); inf where one is finite and the other is not."""
  cap = np.asarray(captured, np.float64).T
  rep = np.asarray(replayed, np.float64)[:, :cap.shape[1]]
  fin = np.isfinite(cap)
  if rep.shape != cap.shape or not np.array_equal(fin, np.isfinite(rep)):
    return float('inf')
  if not fin.any():
    return 0.0
  return float(np.abs(rep[fin] - cap[fin]).max()
               / (1.0 + np.abs(cap[fin]).max()))


def _rows(x, idx):
  """The rows `idx` of every tensor of a batched dataclass (Data)."""
  if torch.is_tensor(x):
    return x[idx]
  if dataclasses.is_dataclass(x):
    return dataclasses.replace(x, **{
        f.name: _rows(getattr(x, f.name), idx) for f in dataclasses.fields(x)})
  return x


def _substep_stats(m, before, after) -> dict:
  """The diagnostics of one substep from the state before it to the one
  after: max |qvel| after, the active contacts of each pool after, the
  deepest contact after, and the Newton steps the substep took."""
  s = m.stat
  d = pipeline.fwd_position(m, after)
  active = ((d.contact.dist - d.contact.includemargin) < 0).cpu().numpy()
  sl3, sl1 = constraint.compaction_slot_pools(s)
  pre = pipeline.fwd_velocity(m, pipeline.fwd_position(m, before))
  pre = smooth.fwd_smooth(m, smooth.actuation(m, pre))
  args = solver.newton_args(pre, constraint.make_efc(m, pre))
  return {
      'qvel_max': after.qvel.abs().amax(-1).double().cpu().numpy(),
      'n_act3': active[:, sl3].sum(-1),
      'n_act1': active[:, sl1].sum(-1),
      'min_dist': d.contact.dist.amin(-1).double().cpu().numpy(),
      'newton_steps': solver.newton_steps(args, *solver.solver_params(s))
                      .cpu().numpy(),
  }


def _report(tag: str, m, per_env, traj: list, place,
            qvel_limit: float, launches: dict) -> dict:
  """The variant's rows, from the captured envs' rows `place` of its
  trajectory; `per_env`: the model fields that carry an env axis."""
  envs = int(traj[0].qpos.shape[0])
  idx = torch.as_tensor(place, device=traj[0].qpos.device)
  m = m.replace(**{k: getattr(m, k)[idx] for k in per_env})
  traj = [_rows(d, idx) for d in traj]
  rows, peaks, blew = [], [], False
  for i, (before, after) in enumerate(zip(traj[:-1], traj[1:])):
    st = _substep_stats(m, before, after)
    qv = st['qvel_max']
    peaks.append(qv)
    bad = ~np.isfinite(qv) | (qv > qvel_limit)
    blew = blew or bool(bad.any())
    rows.append({
        'substep': i + 1,
        'qvel_max_p50': float(np.median(qv)),
        'qvel_max_max': float(np.max(qv)),
        'n_bad': int(bad.sum()),
        'n_act3_max': int(st['n_act3'].max()),
        'n_act1_max': int(st['n_act1'].max()),
        'min_dist': float(st['min_dist'].min()),
        'newton_steps_max': int(st['newton_steps'].max()),
    })
  return {'variant': tag, 'envs': envs,
          'ncon_cap': int(m.stat.ncon_cap),
          'ncon_cap1': int(m.stat.ncon_cap1), 'reproduced': blew,
          'launches': launches, 'substeps': rows,
          'qvel_peaks': np.stack(peaks, axis=1)}


def _run(step, m, data, n_sub: int):
  """[data, n_sub substeps of `step`], and the kernels' launches."""
  before = dict(LAUNCHES)
  traj = [data]
  for _ in range(n_sub):
    traj.append(step(m, traj[-1]))
  return traj, {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                if v - before.get(k, 0)}


def _engine_replay(env, batch, ctrl, n_sub, dtype, device,
                   iter_mult=1, ls_mult=1, ncon_cap='env'):
  """A model built afresh from the task's compiled scene with the
  variant's solver settings, dtype and compaction cap, on `device`."""
  mj = env.scene.mj_model
  snap = (mj if isinstance(mj, phys_io.ModelArrays)
          else phys_io.ModelArrays.of(mj)).arrays()
  snap['opt.iterations'] = np.asarray(
      int(snap['opt.iterations']) * iter_mult)
  snap['opt.ls_iterations'] = np.asarray(
      int(snap['opt.ls_iterations']) * ls_mult)
  cap = env.cfg.sim.nconmax if ncon_cap == 'env' else ncon_cap
  model = phys_io.put_model(phys_io.ModelArrays(snap), device=device,
                            dtype=dtype, ncon_cap=cap)
  dev = phys_io.resolve_device(device)
  t = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)
  fields = {k: t(v) for k, v in _model_fields(batch).items()
            if hasattr(model, k)}
  skipped = sorted(set(_model_fields(batch)) - set(fields))
  if skipped:
    print(f'# WARNING: captured model fields the engine lacks, skipped: '
          f'{skipped}', flush=True)
  model_b = model.replace(**fields)
  n = batch['qpos'].shape[0]
  data = phys_io.make_batched_data(model, n, device=device)
  data = data.replace(**{k: t(batch[k]) for k in STATE_KEYS if k != 'ctrl'},
                      ctrl=t(ctrl))
  return model_b, _run(pipeline.step, model_b, data, n_sub)


def _placement(batch: dict, num_envs: int) -> np.ndarray:
  """The rows of a `num_envs` batch the captured envs take: each at its
  own env id where the ids are distinct and fit, else the first rows."""
  ids = batch['env_ids']
  n = len(ids)
  if num_envs > n and len(set(ids.tolist())) == n and ids.max() < num_envs:
    return ids.astype(np.int64)
  return np.arange(n)


def _padded(batch: dict, place: np.ndarray, base: dict) -> dict:
  """`base` (num_envs rows of each key) with the captured rows at
  `place`."""
  out = dict(batch)
  for k, v in base.items():
    full = np.array(v, copy=True)
    full[place] = batch[k]
    out[k] = full
  return out


def replay(path: str, task: str = 'Mjlab-Velocity-Flat-Unitree-G1',
           substeps: int = 8, max_dumps: int = 10, variants=VARIANTS,
           device: str = 'cuda', num_envs: 'int | None' = None
           ) -> 'tuple[dict, list]':
  """(the captured batch, one report per variant). The float32 variants
  run `num_envs` envs (default: the captured ones alone), the captured
  envs at their ids (_placement) and the others as the env resets them:
  only the shape of a batch changes how the device rounds (which kernels
  it picks), so at the training's env count the replay repeats training
  bit for bit. eng-f64 runs the captured envs alone on the CPU. Each
  report holds its per-substep rows of the captured envs, its launches,
  `qvel_peaks` (n, substeps) and `peaks_err` (peaks_error against the
  captured peaks)."""
  want = list(variants)
  unknown = sorted(set(want) - set(VARIANTS))
  if unknown:
    raise SystemExit(f'unknown variants {unknown}; known: {VARIANTS}')
  dumps, files = _load_dumps(path, max_dumps)
  batch = _stack_dumps(dumps)
  n = batch['qpos'].shape[0]
  N = max(num_envs or n, n)
  place = _placement(batch, N)
  print(f'# {len(dumps)} dumps, {n} exploding envs (env ids '
        f'{batch["env_ids"].tolist()}) in rows {place.tolist()} of {N}; '
        f'files: {[os.path.basename(f) for f in files]}', flush=True)
  env = registry.make(task, device=device, **{'scene.num_envs': N})
  qvel_limit = float(env.cfg.sanity_qvel_limit)
  dev, f32 = env.device, torch.float32
  t = lambda x: torch.as_tensor(x, dtype=f32, device=dev)

  # the captured state in the env's own state (its other envs as reset);
  # the ctrl of the step the env's action manager makes from the captured
  # processed action
  state, _ = env.init_state(0)
  base = {k: getattr(state.data, k) for k in STATE_KEYS}
  base['processed_action'] = torch.zeros_like(state.actions)
  base.update({'model_' + k: getattr(state.model, k)
               for k in _model_fields(batch) if hasattr(state.model, k)})
  full = _padded(batch, place, {k: v.cpu().numpy() for k, v in base.items()})
  state = state.replace(data=state.data.replace(
      **{k: t(full[k]) for k in STATE_KEYS}))
  fields = {k: t(v) for k, v in _model_fields(full).items()
            if hasattr(state.model, k)}
  state = state.replace(model=state.model.replace(**fields))
  ctx = env._make_ctx(state)
  processed = t(full['processed_action'])
  apply = lambda d: env.action_manager.apply(ctx, d, processed)
  ctrl = apply(state.data).ctrl.cpu().numpy()

  results = []
  for tag in want:
    if tag == 'env-f32':
      m, at = state.model, place
      traj, launches = _run(lambda m_, d: pipeline.step(m_, apply(d)), m,
                            state.data, substeps)
    else:
      kw = {'eng-f32': {}, 'eng-f64': {}, 'eng-it3x': dict(iter_mult=3,
                                                         ls_mult=2),
            'eng-nocap': dict(ncon_cap=0)}[tag]
      if tag == 'eng-f64':
        args = (batch, ctrl[place], substeps, torch.float64, 'cpu')
        at = np.arange(n)
      else:
        args = (full, ctrl, substeps, f32, device)
        at = place
      m, (traj, launches) = _engine_replay(env, *args, **kw)
    per_env = [k for k in _model_fields(batch) if hasattr(m, k)]
    r = _report(tag, m, per_env, traj, at, qvel_limit, launches)
    r['peaks_err'] = peaks_error(batch['qvel_peaks'], r['qvel_peaks'])
    results.append(r)
  return batch, results


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__,
                              formatter_class=argparse.RawTextHelpFormatter)
  p.add_argument('dump', help='blowup_ring.npz, or a directory of '
                 'blowup_*.npz')
  p.add_argument('--task', default='Mjlab-Velocity-Flat-Unitree-G1')
  p.add_argument('--substeps', type=int, default=8)
  p.add_argument('--max-dumps', type=int, default=10)
  p.add_argument('--variants', default=','.join(VARIANTS))
  p.add_argument('--device', default='cuda')
  p.add_argument('--num-envs', type=int, default=None,
                 help='run the float32 variants at this many envs, each '
                 'captured env at its id (the training\'s count repeats '
                 'training bit for bit)')
  args = p.parse_args(argv)
  batch, results = replay(args.dump, args.task, args.substeps,
                          args.max_dumps, args.variants.split(','),
                          args.device, args.num_envs)
  for r in results:
    print(json.dumps({k: v for k, v in r.items() if k != 'qvel_peaks'}),
          flush=True)
  print('\n# summary (peaks_err: the first substeps against the captured '
        'qvel_peaks, over 1 + max |captured|)')
  for r in results:
    peaks = ' '.join(f'{row["qvel_max_max"]:.4g}' for row in r['substeps'])
    print(f'  {r["variant"]:10s} reproduced={r["reproduced"]} '
          f'peaks_err={r["peaks_err"]:.3e} max|qvel| by substep [{peaks}] '
          f'({r["envs"]} envs, caps {r["ncon_cap"]} + {r["ncon_cap1"]}, '
          f'launches {r["launches"]})', flush=True)
  return batch, results


if __name__ == '__main__':
  main()
