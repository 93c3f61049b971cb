#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check its kernels.

Run from the repository root on a host with a CUDA GPU and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. print the card's name and power limit; build the CUDA kernels
     (mjlab_torch/csrc, one nvcc per source, in parallel);
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes (Unitree G1 flat scene, 4096 envs, float32) and time both; then
     the edge cases of K3 (ragged batches, slide joints, gravity off, a
     spinning root, a model without sites, other block sizes), K1 (n from
     1 to 64, ragged batches) and K2 (batches of 1 and 33, envs without
     contact, the iteration cap); 2f: K4 (the contact rows of the
     compacted pools) at the training cell's 16384 envs, timed alone, with
     the pools' selection and beside its plain version;
  3. run the physics path: the G1 flat scene at 4096 envs through the public
     entry points (put_model, make_batched_data, step) for 100 substeps,
     with every launch counter reset just before and read just after,
     then time one substep stage by stage, and K2 alone on the settled
     state that path reached;
  4. hold a short CUDA rollout against the float64 CPU plain path;
  5. run the environment path: `Mjlab-Velocity-Flat-Unitree-G1` at 4096
     envs through `registry.make`, `env.reset` and `env.step` under the
     shipped policy's actor (5a: build and reset; 5b: 150 env-steps with
     noise, pushes and resets on, launches counted per env-step (K3, K2,
     K1, K4: 4/4/8/4, or 5/5/9/5 with a reset), then 50
     env-steps under zero actions; 5c: 8 envs on the card in float32
     against the CPU in float64; 5d: env-steps per second and one env-step
     stage by stage);
  6. run the training path: `python -m mjlab_torch.scripts.train` of the
     same task at 4096 envs and the registered network widths (6a: 3 PPO
     iterations through `train.main`, launches counted per rollout env-step,
     logs, parameters and the checkpoint checked, the deployment ONNX
     written beside it read back and evaluated in numpy against the
     runner's inference policy, then the synchronizing calls of one rollout
     and one update counted; 6b: the checkpoint loaded into a fresh runner
     bit for bit, and a run resumed from it; 6c: one learn iteration of 8
     envs on the card in float32 against the port on the CPU with the env
     in float64; 6d: `scripts/play.main` of the checkpoint);
  7. run the G1 velocity shape of BASELINE config 5 (a policy observation
     history of 5; foot friction, pelvis mass and joint damping randomized
     per env at startup, as __graft_entry__.py builds it) at 4096 envs
     through `registry.make` and the PPO runner (7a: the per-env model
     fields and the observation width; 7b: 50 env-steps, every K3 launch in
     its per-env form, launches and waits an env-step; 7c: 3 PPO iterations
     at the registered widths, resets by cause; 7d: 8 envs on the card in
     float32 against the CPU in float64 with the same per-env values);
  8. run the Unitree Go1 flat velocity task (BASELINE config 2; nv 18,
     57 contact slots without compaction, a box trunk) through its entry
     points (8a: `registry.make` at 4096 envs and the model's widths; 8b:
     100 env-steps under random actions with noise, pushes and resets on,
     launches and waits an env-step, the plane-box pair active; 8c:
     `scripts/demo.main` in a fresh log root, which finds no policy,
     trains 3 PPO iterations at the registered 1024 envs through
     `train.main`, exports the ONNX and plays; 8d: 8 envs on the card in
     float32 against the CPU in float64);
  9. run the Unitree G1 motion-tracking task (BASELINE config 4) on the
     shipped walk clip (9a: `registry.make` at 4096 envs, K3's per-env form
     at the task's segments (bconst and qpos0) held against its plain
     version and timed beside the shared form, 100 env-steps under the
     shipped tracking policy with one env tipped past `anchor_ori` and one
     with its arm folded into the torso, launches and waits an env-step,
     one env-step stage by stage; 9b: 3 PPO iterations through
     `train.main` at the registered widths with observation normalization
     on, the motion-baked ONNX read back against the policy and the clip,
     the checkpoint reloaded bit for bit and resumed; 9c: `scripts.demo` plays the shipped policy on its own
     clip, then the Play cfg at 512 envs for 250 env-steps under the
     shipped policy and under zero actions, whose episodes ended by
     tracking terms are compared; 9d: 8 envs on the card in float32
     against the CPU in float64);
 10. run the rough-terrain velocity tasks (heightfield terrain regenerated
     from its seed, the terrain-level curriculum): 10a:
     `registry.make('Mjlab-Velocity-Rough-Unitree-G1')` at 4096 envs, the
     heightfield's size and bytes on the card, the slots, caps, contact rows
     and nefc, and whether K2 takes them; 10b: 150 env-steps under the
     shipped G1 flat actor with noise, pushes and resets on, launches and
     waits an env-step, every heightfield pair active, the collision gate
     (no active heightfield contact deeper than ROUGH_PEN_GATE), the
     active heightfield contacts whose normal points down, the
     curriculum's levels, fell_over by level, one env-step and one substep
     stage by stage, peak memory; 10c: 3 PPO iterations through
     `train.main`, the terrain-level metric logged, the ONNX read back,
     then `scripts.play` of the G1 rough Play cfg at 4096 envs with that
     checkpoint; 10d: `Mjlab-Velocity-Rough-Unitree-Go1` at 4096 envs for
     100 env-steps under random actions (91 slots compacted to 64, 256
     contact rows), K2 at that shape against its plain version and timed,
     then `scripts.demo` of the Go1 rough task (3 PPO iterations at 4096
     envs through `train.main`, the ONNX read back, play) and
     `scripts.play` of its Play cfg at 4096 envs; 10e: 8 envs of each
     rough task on the card in float32 against the CPU in float64. The
     launches of phase 10 are those of the path's own runs: env builds
     and resets, env-steps, training and play;
 11. run the physics-blowup tools on G1 flat training at 4096 envs (11a:
     `scripts.train --enable-nan-guard` with MJLAB_BLOWUP_DUMP for 3
     iterations, env NAN_ENV's base spun to NAN_SPIN rad/s before
     env-step NAN_STEP: one guard dump with that env, the ring holding its
     pre-substep state bit for bit, physics_nan counting it, finite
     losses, launches 4/4/8 or 5/5/9, the checkpoint equal to one without
     the ring, then 24 waits in a guarded rollout with the ring on; 11b:
     `scripts.blowup_replay` of the ring on the card at 4096 envs, whose
     float32 replays must repeat the captured qvel peaks within 1e-5 of
     (1 + max |qvel|), eng-f64 on the CPU; 11c: `scripts.nan_viz` of the
     dump; 11d: the env-step at 4096 envs with the guard and the ring off
     and on, in turns);
 12. run the Tiny tasks and the elliptic friction cone (12a: K1-K3 at the
     TinyBot's shapes on 4096 TinyBot floor states, and K1 on the Hessians
     of every plain Newton iteration of the elliptic G1 at 4096 envs, each
     against its plain version; 12b: the three Tiny tasks, registered
     through MJLAB_TASKS_MODULES, at 4096 envs for TINY_STEPS env-steps
     under random actions (launches and waits an env-step; Rough-Tiny's
     heightfield pairs active and its levels moving), then TINY_ITERS PPO
     iterations each through `train.main` with the ONNX read back
     (Tracking-Tiny on a clip of `write_tiny_motion`), then Flat-Tiny's 8
     envs on the card in float32 against the CPU in float64; 12c:
     `Mjlab-Velocity-Flat-Unitree-G1` with cone='elliptic' at 4096 envs
     for ELL_STEPS env-steps under the shipped flat actor, K2 never
     launched and K1 ELL_K1 times an env-step, one substep stage by
     stage, 3 PPO iterations through `train.main` with `--env.sim.mujoco.
     cone elliptic`, 8 envs on the card against the CPU);
 13. run multi-GPU training, `scripts.train --shard` of G1 flat at 4096
     envs with one minibatch an epoch, the runs compared with another
     with the actions clipped to 0 and a fixed learning rate (13a: started
     plainly, a world of one over NCCL for SHARD_ITERS iterations,
     launches 4/4/8 or 5/5/9 an env-step, one sync an env-step of a
     rollout after the first and none in the update, the training checks,
     iteration 1's logs and parameters within 1e-5 of an unsharded
     `train.main` at the same seed, its checkpoint loaded into an
     unsharded runner bit for bit and trained on, then training
     env-steps/s sharded and unsharded in turns, the last two under the
     policy's actions; which collectives gloo takes CUDA tensors for; 13b:
     `torch.distributed.run --nproc_per_node 2 chip_smoke.py
     --shard-rank`, two gloo ranks of 2048 envs on the one card for
     SHARD2_ITERS iterations, each launching 4/4/8 or 5/5/9 an env-step,
     their parameters identical to the bit after each iteration, each
     rank's first env-step within 1e-4 of its rows of the unsharded one,
     iteration 1's loss, kl and mean reward within rtol 1e-3 of the
     unsharded run, its parameters by phase 6c's rule (every element
     within 2 lr x steps, under 1 % beyond lr / 10) and Adam's moments
     after the first Adam step within 1e-5 of (1 + max |plain|), the
     checkpoint of 4096 envs loaded and trained on at a world of one);
 14. run the engine's oracle models of equality constraints, tendons,
     mocap bodies and sensors (asset_zoo/oracle_models.py: connect, weld,
     joint, the four-bar, the mocap weld, the tendon model and the sensor
     robot) through put_model, make_batched_data and step at 4096 envs
     (14a: each from seeded states under seeded controls for
     ORACLE_SUBSTEPS substeps, ORACLE_PLAIN_SUBSTEPS where the plain
     Newton solves its equality rows, the mocap target moving on a circle,
     launches a substep equal to ORACLE_LAUNCHES, everything finite, the
     equality residual within ORACLE_RESIDUAL, the welded box within
     ORACLE_LAG of its target, tendon-limit rows active in some envs,
     substeps/s, the run's first 8 envs (float32) against the CPU in
     float64 over its first 20 substeps; 14b: K2 at the tendon model's and the robot's
     shapes and K1 on every Hessian of the four-bar's plain Newton, each
     against its plain version and timed, one four-bar substep stage by
     stage and the equality block's share of it);
 15. run the convex pile (asset_zoo/oracle_models.py: nine free solids
     over a plane, every collider group of ellipsoids, cylinders and mesh
     hulls) through put_model, make_batched_data and step at 4096 envs
     (15a: from seeded states (pile_states) for PILE_SUBSTEPS substeps,
     launches a substep equal to PILE_LAUNCHES, everything finite, each of
     the 18 groups this slice ported active in some env, no active
     contact of the last PILE_LAST substeps deeper than PILE_PEN_GATE,
     every |qvel| and body position within PILE_QVEL_GATE and
     PILE_FAR_GATE, substeps/s; then, for each of the 18 groups, the env
     of its earliest first contact over a window around that contact
     (PILE_WINDOW), the card (float32) against the CPU in float64 from
     the card's state, contact-activation flips allowed within
     PILE_FLIP_GAP of the threshold; 15b: each of those groups timed, with
     its host issue, one substep stage by stage, and K1-K3
     at the pile's shapes against their plain versions, each a row of the
     kernels line);
 16. the spec path's model on the card (16a: the JAX package's round-4
     blowup ring, artifacts/blowups_r4/blowup_ring.npz, replayed through
     scripts/blowup_replay.py on the G1 flat task, its 40 rows tiled over
     4096 envs for RING_SUBSTEPS substeps: env-f32 and eng-f32 on the
     card, eng-f64 on the CPU at the ring's 40 envs; every state finite,
     launches (K3, K2, K1) a substep equal to RING_LAUNCHES, every copy of
     a ring row the same trajectory to the bit, not reproduced, each
     substep's max |qvel| (largest and median over the ring) within
     RING_TOL relative of replay_fixed.txt's and the largest within
     RING_TOL of (1 + max) of the CPU float64 replay, then K1-K3 at the
     ring's state against their plain versions; 16b: each of the 15
     registered tasks' scenes takes its committed snapshot by digest with
     no mujoco loaded, and a G1 flat cfg with the knee ActuatorCfg's
     stiffness doubled is refused, naming both digests; 16c: the G1 flat
     env-step at 4096 envs on the 69-geom snapshot, RING_STEP_RUNS timed
     runs of RING_STEP_STEPS env-steps);
 17. the viewer stack's device side on G1 flat at 4096 envs (17a:
     `train.main` for TRAIN_ITERS iterations with `--agent.video True`,
     a video every iteration of VIDEO_LENGTH frames: launches 4/4/8 or
     5/5/9 an env-step, each iteration's `rl-video-iter-{k}.mp4.qpos.npy`
     (no mujoco on the card) of (min(VIDEO_LENGTH, 24 k), nq) and finite,
     the last frame env 0's final qpos bit for bit, the render branch
     naming the missing mujoco, the checkpoint phase 6a's (the same run
     without video) bit for bit, 24 waits in a recording rollout; the
     collection ms with and without video, and rollouts without and with
     the record in turns; 17b: `scripts.play` of the
     shipped policy on the Play cfg for RENDER_STEPS env-steps with
     `--render --tile RENDER_TILE`, its statistics those of the same play
     without `--render`, the same waits an env-step as that play, the
     trajectory (RENDER_STEPS, RENDER_TILE, nq), finite, its last frame
     the final qpos of envs 0-3 bit for bit; 17c: `utils.hbm`'s report of
     one env-step, its peak bytes, bytes an env and the card's capacity,
     `assert_fits` passing, and refusing at half the peak);
 18. the profile CLI (scripts/profile.py) through its parser on G1 flat
     at 4096 envs, PROFILE_REPS reps: with `--trace DIR` (the stage report,
     every label of PROFILE_LABELS in the JAX script's order with a finite
     time above 0; the trace's device events naming K1-K3's functions;
     whether the card's DRAM counters could be read, or why not), then
     with `--roofline` (the FLOPs and bytes of a substep and an env-step
     finite and above 0, each kernel charged, FLOP/s at most the f32
     peak); launches 4/4/8 or 5/5/9 on every env-step of both runs.
Phase 2 also holds K3's per-env form (2d: every segment of its float table
per env at 4096 envs, then body_mass alone, small batches and the model
variants) against its plain version and times it beside the shared-table
form, and K1-K3 at the Go1's shapes (2e: 4096 Go1 envs on the floor, a
third of them on their backs with the trunk box flat, so the plane-box
rows are active). The line before the last is a JSON object with one row
per kernel (K3's per-env form a row of its own, its launches those of
phase 7 and its `tracking` its phase-9a numbers; each row's `go1` holds
its phase-2e numbers, `go1_path_launches` its launches in phase 8,
`tracking_path_launches` those in phase 9, `rough_path_launches` those
in phase 10, `nan_path_launches` those in phase 11, `tiny_path_launches`
those in phase 12b, `elliptic_path_launches` those in phase 12c and
`shard_path_launches` those of phase 13's sharded runs (13a's two and
both ranks' in 13b; the unsharded runs they are compared with count for
no path), `oracle_path_launches` those of phase 14a's runs; K2's
row holds its phase-10d numbers as `rough_go1` and its phase-14b numbers
as `oracle_tendon` and `oracle_robot`, each row its phase-12a
numbers at the TinyBot's shapes as `tiny`, K1's its numbers on the
elliptic Hessians as `elliptic_hessians` and on the four-bar's as
`oracle_fourbar_hessians`; each row's `pile_path_launches` its
launches in phase 15a, `replay_path_launches` those of phase 16a's env-f32
replay, `video_path_launches` and `render_path_launches` those of phases
17a and 17b, `profile_path_launches` those of phase 18's two runs, K1-K3's numbers at the ring's state its `ring`, and K1-K3's rows
at the pile's shapes follow the others); the last
line is {"ok":
true, "device": {...}}. Needs one GPU; imports no JAX and no mujoco.
`python3 chip_smoke.py --shard-rank ROOT TRAIN_ARGS...` is one rank of
phase 13b, started by the script itself under torch.distributed.run.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

B = 4096
SUBSTEPS = 100
ENV_TASK = 'Mjlab-Velocity-Flat-Unitree-G1'
ENV_STEPS = 150  # 3 s of the 50 Hz control loop
ZERO_STEPS = 50
TRAIN_ITERS = 3  # PPO iterations of phases 6a and 7c
ENV_STEPS_5 = 50  # env-steps of phase 7b
GO1_TASK = 'Mjlab-Velocity-Flat-Unitree-Go1'
GO1_STEPS = 100  # env-steps of phase 8b


def fail(msg: str) -> None:
  print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
  sys.exit(1)


def check(ok: bool, msg: str) -> None:
  if not ok:
    fail(msg)


def time_ms(torch, fn, reps: int, warmup: int = 2, busy=None) -> float:
  """Median time of one call, by CUDA events around each call on an idle
  card: the host's path to the launch is part of it. With `busy` (a square
  CUDA matrix) the events are queued behind a matrix product of a few
  milliseconds, which keeps the card at work while the host enqueues the
  call, so what is left is the kernel's own time on the device."""
  for _ in range(warmup):
    fn()
  sink = None if busy is None else torch.empty_like(busy)
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if busy is not None:
      torch.mm(busy, busy, out=sink)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def count_syncs(torch, fn):
  """(fn(), the messages of the synchronizing CUDA calls fn made), counted
  by torch.cuda.set_sync_debug_mode."""
  import warnings
  torch.cuda.set_sync_debug_mode('warn')
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      out = fn()
  finally:
    torch.cuda.set_sync_debug_mode('default')
  return out, [str(w.message) for w in caught
               if 'synchroniz' in str(w.message)]


def g1_states(torch, phys, mj, m, batch: int, drop: float, gen):
  """`batch` G1 flat envs near the keyframe (float32, on the model's
  device): joint noise, a unit root quaternion, random velocities, the
  root lowered by `drop` metres. `gen` is a CPU torch.Generator."""
  s, dev = m.stat, m.dof_damping.device
  key = torch.as_tensor(mj.key_qpos[0], dtype=torch.float32)
  qpos = key.expand(batch, -1).clone()
  qpos[:, 7:] += 0.05 * torch.randn(batch, s.nq - 7, generator=gen)
  qpos[:, 3:7] += 0.02 * torch.randn(batch, 4, generator=gen)
  qpos[:, 3:7] /= qpos[:, 3:7].norm(dim=-1, keepdim=True)
  qpos[:, 2] -= drop
  qvel = 0.5 * torch.randn(batch, s.nv, generator=gen)
  ctrl = torch.as_tensor(mj.key_ctrl[0], dtype=torch.float32).expand(
      batch, -1).clone()
  d = phys.make_batched_data(m, batch)
  return d.replace(qpos=qpos.to(dev), qvel=qvel.to(dev), ctrl=ctrl.to(dev))


def go1_floor_states(key_qpos, nv: int, batch: int, seed: int):
  """`batch` Go1 flat states on the floor as numpy (qpos, qvel) from
  numpy's default_rng(seed), in turns: upside down with the trunk box
  lying flat 2 mm deep in the floor (its four lowest corners at one depth,
  the tie the collider's stable sort decides), upside down and tilted up to
  0.1 rad, and standing from `key_qpos` (the keyframe) with joint noise,
  dropped 3 cm. Velocities are drawn with std 0.3."""
  import numpy as np
  rng = np.random.default_rng(seed)
  qpos = np.tile(np.asarray(key_qpos, np.float64), (batch, 1))
  qpos[:, 7:] += 0.05 * rng.normal(size=(batch, qpos.shape[1] - 7))
  kind = np.arange(batch) % 3
  tilt = np.where(kind == 1, 1.0, 0.0)[:, None] * rng.uniform(
      -0.1, 0.1, (batch, 2))
  # (0, 1, 0, 0), half a turn about x, then the tilt about x and y
  hx, hy = tilt[:, 0] / 2, tilt[:, 1] / 2
  flip = np.stack([-np.sin(hx) * np.cos(hy), np.cos(hx) * np.cos(hy),
                   np.sin(hx) * np.sin(hy), -np.cos(hx) * np.sin(hy)], -1)
  up = kind < 2
  qpos[up, 3:7] = flip[up]
  qpos[up, 2] = np.where(kind[up] == 0, 0.048, 0.05)
  qpos[~up, 2] -= 0.03
  qvel = 0.3 * rng.normal(size=(batch, nv))
  return qpos, qvel


def g1_variant(base, slide=(), gravity_off=False, drop_sites=False):
  """A variant of the compiled-model snapshot `base` (a ModelArrays) that
  reaches branches of the smooth stage the G1 itself does not: the joints
  `slide` turned from hinge into slide joints, the gravity disable bit
  set, the sites cut away."""
  import numpy as np
  from mjlab_torch.physics.io import ModelArrays
  a = base.arrays()
  if slide:
    a['jnt_type'] = a['jnt_type'].copy()
    a['jnt_type'][list(slide)] = 2  # mjJNT_SLIDE
  if gravity_off:
    a['opt.disableflags'] = np.asarray(
        int(a['opt.disableflags']) | (1 << 6))  # mjDSBL_GRAVITY
  if drop_sites:
    a['nsite'] = np.asarray(0)
    for k in ('site_bodyid', 'site_pos', 'site_quat', 'name_siteadr'):
      a[k] = a[k][:0]
  return ModelArrays(a)


K3_SLIDE_JOINTS = (4, 11, 17, 29)  # both legs, the waist, a wrist


def k3_variants(base) -> dict:
  """The model variants of K3's edge-case gates, by name."""
  return {
      'slide': g1_variant(base, slide=K3_SLIDE_JOINTS),
      'slide, gravity off': g1_variant(base, slide=K3_SLIDE_JOINTS,
                                       gravity_off=True),
      'no sites': g1_variant(base, drop_sites=True),
  }


def per_env_k3_model(torch, m, batch: int, gen, fields=None):
  """Model `m` with the fields of K3's float table (every one, or
  `fields`) given an env axis of `batch` and distinct values from the CPU
  generator `gen`: masses, inertias and armature scaled by [0.8, 1.2],
  positions moved by up to 1 cm, quaternions and joint axes turned a few
  degrees and normalized, qpos0 moved by up to 0.01."""
  from mjlab_torch.ops import smooth_kernel as k_smooth
  out = {}
  for f in k_smooth.FLOAT_TABLE_FIELDS if fields is None else fields:
    x = getattr(m, f).detach().cpu().double()
    x = x.expand((batch,) + tuple(x.shape))
    u = lambda lo, hi, x=x: lo + (hi - lo) * torch.rand(
        x.shape, generator=gen, dtype=torch.float64)
    if f in ('body_mass', 'body_inertia', 'dof_armature'):
      v = x * u(0.8, 1.2)
    elif f.endswith('quat') or f == 'jnt_axis':
      v = x + 0.03 * torch.randn(x.shape, generator=gen, dtype=torch.float64)
      v = v / v.norm(dim=-1, keepdim=True)
    else:  # positions, qpos0
      v = x + u(-0.01, 0.01)
    out[f] = v.to(device=m.device, dtype=m.dtype)
  return m.replace(**out)


def k3_compared(kern: dict, nsite: int) -> dict:
  """K3's outputs held against the plain version: a model without sites
  has no site frames (the kernel leaves their padded row unwritten)."""
  return {k: v for k, v in kern.items()
          if nsite or not k.startswith('site_')}


def k3_rel_err(torch, kern: dict, plain, nsite: int) -> float:
  """Worst max |kernel - plain| / (1 + max |plain|) over K3's compared
  outputs (k3_compared)."""
  worst = 0.0
  for key, got in k3_compared(kern, nsite).items():
    if not bool(torch.isfinite(got).all()):
      return float('inf')
    worst = max(worst, rel_err(got, getattr(plain, key)))
  return worst


def k3_max_err(kern: dict, plain, nsite: int) -> float:
  """Worst max |kernel - plain| over K3's compared outputs."""
  return max(max_err(v, getattr(plain, k))
             for k, v in k3_compared(kern, nsite).items())


def k2_dropped_input(torch, phys, mj, m, batch: int, gen):
  """K2's tensor arguments for `batch` G1 flat envs dropped 3 cm into the
  floor, and make_efc's rows. Phase 2c's input is this with the generator
  seeded 0 and one g1_states batch (phase 2a's) drawn from it before."""
  from mjlab_torch.physics import constraint, pipeline, smooth, solver
  d = g1_states(torch, phys, mj, m, batch, 0.03, gen)
  d = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  d = smooth.fwd_smooth(m, smooth.actuation(m, d))
  efc = constraint.make_efc(m, d)
  return solver.newton_args(d, efc), efc


def random_newton_args(torch, batch: int, n: int, ncr: int, nl: int, gen):
  """A random structured Newton problem on the card (float32, bool masks):
  K2's tensor arguments and an ldof of nl distinct dofs. `gen` is a CUDA
  torch.Generator. M is well conditioned, half of the contact rows are
  active, and c_D is zero on the inactive ones, as make_efc leaves it."""
  def rnd(*shape):
    return torch.randn(*shape, generator=gen, device='cuda')

  def coin(p, *shape):
    return torch.rand(*shape, generator=gen, device='cuda') < p

  A = 0.1 * rnd(batch, n, n)
  M = A @ A.transpose(1, 2) + 2.0 * torch.eye(n, device='cuda')
  a0 = rnd(batch, n)
  ws = a0 + 0.01 * rnd(batch, n)
  cJ, c_aref = 0.5 * rnd(batch, ncr, n), rnd(batch, ncr)
  c_act = coin(0.5, batch, ncr)
  cD = 20 * rnd(batch, ncr).abs() * c_act
  l_sign = torch.where(coin(0.5, batch, nl), 1.0, -1.0)
  l_aref, lD = rnd(batch, nl), 50 * rnd(batch, nl).abs()
  l_act = coin(0.4, batch, nl)
  f_aref, fD = 0.1 * rnd(batch, n), 30 * rnd(batch, n).abs()
  floss, f_act = 2 * rnd(batch, n).abs(), coin(0.5, batch, n)
  perm = torch.randperm(n, generator=gen, device='cuda')
  ldof = tuple(int(i) for i in perm[:nl].sort().values)
  args = (M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD, l_act,
          f_aref, fD, floss, f_act)
  return [t.contiguous() for t in args], ldof


def max_err(a, b) -> float:
  return float((a.double() - b.double()).abs().max())


def scale(a) -> float:
  return 1.0 + float(a.double().abs().max())


def rel_err(a, b) -> float:
  """max |a - b| over (1 + max |b|); 0 for empty tensors."""
  return max_err(a, b) / scale(b) if b.numel() else 0.0


def degenerate_ranges(cfg, num_envs):
  """Collapse every sampling range of a flat velocity cfg to a point, so
  that no output depends on a random draw while every code path still runs:
  resets move and turn the root, commands resample inside a few steps,
  pushes fire every third step, observation noise is a constant offset.
  Params, ranges and noise objects are replaced, never edited, so a cfg
  that shares them with other instances can be given too."""
  import dataclasses
  cfg.scene.num_envs = num_envs

  def params(term, **new):
    term.params = {**term.params, **new}

  ev = cfg.events
  params(ev.reset_base, pose_range={
      'x': (0.3, 0.3), 'y': (-0.2, -0.2), 'yaw': (0.7, 0.7)})
  params(ev.reset_robot_joints, position_range=(1.0, 1.0))
  ev.push_robot.interval_range_s = (0.06, 0.06)
  params(ev.push_robot, velocity_range={'x': (0.3, 0.3), 'y': (0.3, 0.3)})
  params(ev.foot_friction, ranges=(0.45, 0.45))
  tw = cfg.commands.twist
  tw.resampling_time_range = (0.1, 0.1)
  tw.rel_standing_envs = 0.0
  tw.rel_heading_envs = 1.0
  tw.ranges = dataclasses.replace(
      tw.ranges, lin_vel_x=(0.6, 0.6), lin_vel_y=(0.2, 0.2),
      ang_vel_z=(0.3, 0.3), heading=(0.5, 0.5))
  pol = cfg.observations.policy
  for name in ('base_lin_vel', 'base_ang_vel', 'projected_gravity',
               'joint_pos', 'joint_vel'):
    term = getattr(pol, name)
    term.noise = dataclasses.replace(term.noise, n_min=term.noise.n_max)
  # the command-velocity curriculum (on for the Go1) holds the ranges the
  # command draws from: its base range and its stage, each a point
  curr = cfg.curriculum.command_vel
  if curr is not None:
    params(curr, base_range=(0.6, 0.6), velocity_stages=[
        {**s, 'range': (0.6, 0.6)} for s in curr.params['velocity_stages']])
  return cfg


WRENCH_BODY = 'torso_link'
WRENCH_INTERVAL_S = (1.0, 3.0)  # phase 19's interval between two wrenches
WRENCH_FORCE = (-20.0, 20.0)  # N, each component
WRENCH_TORQUE = (-5.0, 5.0)  # N m, each component


def external_wrench(cfg, mdp, term_cfg, interval_range_s=WRENCH_INTERVAL_S,
                    force_range=WRENCH_FORCE, torque_range=WRENCH_TORQUE):
  """`cfg` (a velocity env cfg of either package, with that package's
  `mdp` and `term_cfg` modules) with one more event: a random wrench on
  the robot's torso, drawn anew at each interval, as
  `apply_external_force_torque`."""
  cfg.events.torso_wrench = term_cfg.EventTermCfg(
      func=mdp.apply_external_force_torque, mode='interval',
      interval_range_s=interval_range_s,
      params={'force_range': force_range, 'torque_range': torque_range,
              'asset_cfg': term_cfg.SceneEntityCfg(
                  'robot', body_names=[WRENCH_BODY])})
  return cfg


HISTORY = 5  # the policy's observation history in BASELINE config 5


def full_dr_history(cfg, mdp, term_cfg):
  """A G1 flat velocity cfg of either package (`mdp` its envs.mdp,
  `term_cfg` its managers.term_cfg) in the shape of BASELINE config 5, as
  __graft_entry__.py builds it: a policy observation history of 5, and
  startup events that scale the pelvis mass by [0.9, 1.1] and every
  joint's damping by [0.8, 1.2], beside the task's own foot friction."""
  cfg.observations.policy.history_length = HISTORY
  cfg.events.base_mass = term_cfg.EventTermCfg(
      func=mdp.randomize_field, mode='startup',
      params={'asset_cfg': term_cfg.SceneEntityCfg('robot',
                                                   body_names=['pelvis']),
              'operation': 'scale', 'field': 'body_mass',
              'ranges': (0.9, 1.1)})
  cfg.events.joint_damping = term_cfg.EventTermCfg(
      func=mdp.randomize_field, mode='startup',
      params={'asset_cfg': term_cfg.SceneEntityCfg('robot',
                                                   joint_names=['.*']),
              'operation': 'scale', 'field': 'dof_damping',
              'ranges': (0.8, 1.2)})
  return cfg


DR_FIELDS = ('body_mass', 'dof_damping', 'geom_friction')  # config 5's


def distinct_dr_values(model, num_envs: int, seed: int = 0) -> dict:
  """Per-env values of config 5's fields, distinct across envs, as numpy
  arrays drawn once from `seed`, so that two envs (on two devices, or in two
  packages) can be given the same ones: from the compiled values of
  `model` (a port Model without an env axis), every body's mass scaled by
  [0.8, 1.2], every dof's damping drawn in [0, 1] (the G1's compiled
  damping is zero on every dof, which config 5's scale leaves at zero),
  every geom's sliding friction drawn in [0.3, 1.2]."""
  import numpy as np
  rng = np.random.default_rng(seed)
  out = {f: np.repeat(getattr(model, f).detach().cpu().double().numpy()[None],
                      num_envs, 0) for f in DR_FIELDS}
  out['body_mass'] *= rng.uniform(0.8, 1.2, out['body_mass'].shape)
  out['dof_damping'] = rng.uniform(0.0, 1.0, out['dof_damping'].shape)
  out['geom_friction'][..., 0] = rng.uniform(
      0.3, 1.2, out['geom_friction'].shape[:-1])
  return out


def tip_over_state(torch, state, env_id: int, degrees: float = 80.0,
                   quat=None, pos=None):
  """`state` (an EnvState) with one env's root turned `degrees` about x,
  by default past `fell_over`'s 70: that env terminates on the next
  env-step; or turned to `quat` (w, x, y, z). With `pos`, the root is put
  there, at rest."""
  import math
  data = state.data
  qpos = data.qpos.clone()
  if quat is None:
    half = math.radians(degrees) / 2
    quat = [math.cos(half), math.sin(half), 0.0, 0.0]
  qpos[env_id, 3:7] = torch.tensor(quat, dtype=qpos.dtype,
                                   device=qpos.device)
  if pos is not None:
    qpos[env_id, :3] = pos.to(qpos.dtype)
    qvel = data.qvel.clone()
    qvel[env_id] = 0.0
    data = data.replace(qvel=qvel)
  return state.replace(data=data.replace(qpos=qpos))


def tip_over(torch, env, env_id: int, degrees: float = 80.0) -> None:
  """Tip one env of `env`'s own state over (tip_over_state)."""
  env._state = tip_over_state(torch, env.state, env_id, degrees)


TRACK_TASK = 'Mjlab-Tracking-Flat-Unitree-G1'
TRACK_TIP = 90.0  # degrees: past anchor_ori's 0.8 on the gravity's z


def tracking_degenerate_ranges(cfg, num_envs, motion_file):
  """Collapse every sampling range of a G1 tracking cfg of either package to
  a point, as degenerate_ranges does for velocity: RSI resets move, turn
  and push the root and offset the joints by fixed non-zero amounts,
  pushes fire every third step, the startup randomization of foot
  friction, torso COM and qpos0 writes fixed values, observation noise is a
  constant offset, and adaptive start sampling is off (every episode
  starts at the clip's first frame), on the clip `motion_file`."""
  import dataclasses
  cfg.scene.num_envs = num_envs
  motion = cfg.commands.motion
  motion.motion_file = str(motion_file)
  motion.pose_range = {'x': (0.02, 0.02), 'y': (-0.01, -0.01),
                       'z': (0.005, 0.005), 'roll': (0.05, 0.05),
                       'pitch': (-0.03, -0.03), 'yaw': (0.1, 0.1)}
  motion.velocity_range = {'x': (0.1, 0.1), 'y': (-0.1, -0.1),
                           'z': (0.05, 0.05), 'roll': (0.1, 0.1),
                           'pitch': (-0.1, -0.1), 'yaw': (0.2, 0.2)}
  motion.joint_position_range = (0.02, 0.02)
  motion.disable_adaptive_sampling = True

  def params(term, **new):
    term.params = {**term.params, **new}

  ev = cfg.events
  ev.push_robot.interval_range_s = (0.06, 0.06)
  params(ev.push_robot, velocity_range={
      'x': (0.2, 0.2), 'y': (-0.1, -0.1), 'yaw': (0.3, 0.3)})
  params(ev.foot_friction, ranges=(0.45, 0.45))
  params(ev.com_randomize, ranges=(0.004, 0.004))
  params(ev.qpos0_randomize, ranges=(0.003, 0.003))
  pol = cfg.observations.policy
  for name in ('motion_anchor_pos_b', 'motion_anchor_ori_b', 'base_lin_vel',
               'base_ang_vel', 'joint_pos', 'joint_vel'):
    term = getattr(pol, name)
    term.noise = dataclasses.replace(term.noise, n_min=term.noise.n_max)
  return cfg


ARM_FOLD = {'left_shoulder_roll_joint': -0.2, 'left_elbow_joint': 0.6}


def fold_arm_qpos(qpos, joint_names, qpos_adr, env_id: int):
  """`qpos` (numpy or torch, one row an env) with one env's left arm rolled
  into the torso (ARM_FOLD): its upper arm and elbow press 7-11 mm into
  the torso, so the `self_collision` sensor counts two contacts.
  `joint_names` and `qpos_adr` are the robot's (prefix stripped)."""
  for name, value in ARM_FOLD.items():
    qpos[env_id, int(qpos_adr[list(joint_names).index(name)])] = value
  return qpos


def env_card_vs_cpu(torch, num_envs: int = 8, steps: int = 5):
  """The G1 flat env under the degenerate-range configuration on the card
  in float32 (the kernels) against the port on the CPU in float64 (their
  plain versions), the same actions from numpy's default_rng(0), one env
  tipped over before the third step. Returns (worst observation
  err/(1+max|cpu|), worst reward err/(1+max|cpu|), whether every done flag
  agreed, resets seen)."""
  import numpy as np
  from mjlab_torch.tasks import registry
  envs = [registry.make(
      ENV_TASK, cfg=degenerate_ranges(registry.load_cfg(ENV_TASK), num_envs),
      device=dev, dtype=dt)
      for dev, dt in (('cuda', torch.float32), ('cpu', torch.float64))]
  obs = [env.reset()[0] for env in envs]
  worst_obs = max(rel_err(obs[0][g].cpu(), obs[1][g]) for g in obs[1])
  worst_rew, flags_equal, resets = 0.0, True, 0
  rng = np.random.default_rng(0)
  for i in range(steps):
    act = 0.3 * rng.normal(size=(num_envs, 29))
    if i == 2:
      for env in envs:
        tip_over(torch, env, 1)
    outs = [env.step(torch.as_tensor(act, dtype=env.state.actions.dtype,
                                     device=env.device)) for env in envs]
    (go, gr, gt, gc, _), (co, cr, ct, cc, _) = outs
    worst_obs = max([worst_obs] + [rel_err(go[g].cpu(), co[g]) for g in co])
    worst_rew = max(worst_rew, rel_err(gr.cpu(), cr))
    flags_equal &= bool((gt.cpu() == ct).all()) and bool(
        (gc.cpu() == cc).all())
    resets += int((ct | cc).sum())
  return worst_obs, worst_rew, flags_equal, resets


class StageTimer:
  """`stage(name)` contexts for `env.step_fn`: per stage, the GPU time
  between CUDA events around it and the host time to issue it, summed over
  the stage's entries in one env-step. The card is drained after each
  stage, as in the substep's stage table."""

  def __init__(self, torch):
    self.torch = torch
    self.gpu, self.host = {}, {}

  def __call__(self, name):
    @contextlib.contextmanager
    def timed():
      start = self.torch.cuda.Event(enable_timing=True)
      end = self.torch.cuda.Event(enable_timing=True)
      t0 = time.perf_counter()
      start.record()
      yield
      end.record()
      self.host[name] = self.host.get(name, 0.0) + (
          time.perf_counter() - t0) * 1e3
      end.synchronize()
      self.gpu[name] = self.gpu.get(name, 0.0) + start.elapsed_time(end)

    return timed()


def env_path(torch, card: str) -> dict:
  """Phase 5: the environment path at 4096 envs. Returns the kernels'
  launches over the 150 policy steps."""
  import re

  from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
  from mjlab_torch.asset_zoo.unitree_g1 import FOOT_REGEX
  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.tasks import registry
  from mjlab_torch.tasks.velocity import mdp

  # ---- 5a: build and reset -------------------------------------------------
  t0 = time.perf_counter()
  env = registry.make(ENV_TASK, **{'scene.num_envs': B})  # cuda, float32
  actor = load_actor(G1_FLAT_POLICY)
  obs, _ = env.reset()
  torch.cuda.synchronize()
  print(f'env: built and reset {B} envs in {time.perf_counter() - t0:.2f} s '
        f'(obs {env.observation_dims}, actions {env.action_dim})', flush=True)
  check(env.device.type == 'cuda', 'the env is not on the card')
  for g in ('policy', 'critic'):
    check(tuple(obs[g].shape) == (B, 99), f'obs {g} has shape {obs[g].shape}')
    check(bool(torch.isfinite(obs[g]).all()), f'obs {g} is not finite')
  st, view = env.state, env.scene['robot']
  ngeom = env.model.stat.ngeom
  fric, base = st.model.geom_friction, env.scene.model.geom_friction
  check(tuple(fric.shape) == (B, ngeom, 3),
        f'geom_friction has shape {tuple(fric.shape)}')
  foot = torch.zeros(ngeom, dtype=torch.bool, device=fric.device)
  foot[[int(view.idx.geom_ids[i]) for i, n in enumerate(view.idx.geom_names)
        if re.match(FOOT_REGEX, n)]] = True
  f0 = fric[:, foot, 0]
  print(f'env: {int(foot.sum())} foot geoms, friction min {float(f0.min()):.4f}'
        f' max {float(f0.max()):.4f} mean {float(f0.mean()):.4f} std '
        f'{float(f0.std()):.4f}', flush=True)
  check(int(foot.sum()) == 14, 'expected 14 foot geoms')
  check(float(f0.min()) >= 0.3 and float(f0.max()) <= 1.2
        and float(f0.std()) > 0.2, 'foot friction is not spread over '
        '[0.3, 1.2]')
  check(torch.equal(fric[:, ~foot], base[~foot].expand(B, -1, -1))
        and torch.equal(fric[:, foot, 1:], base[foot, 1:].expand(B, -1, -1)),
        'friction changed outside the foot geoms\' first column')
  origins = env.scene.env_origins
  off = view.root_pos_w(st.data)[:, :2] - origins[:, :2]
  print(f'env: origins span {float(origins[:, 0].min()):.1f}..'
        f'{float(origins[:, 0].max()):.1f} m; root offset from origin max '
        f'{float(off.abs().max()):.4f} std {float(off.std()):.4f}', flush=True)
  check(float(off.abs().max()) <= 0.5 + 1e-4 and float(off.std()) > 0.2,
        'root xy is not origin + a draw in [-0.5, 0.5]')
  cmd = st.command['twist']['command']
  check(float(cmd[:, 0].abs().max()) <= 1.0
        and float(cmd[:, 1].abs().max()) <= 0.5
        and float(cmd[:, 2].abs().max()) <= 1.0, 'command outside its ranges')

  # ---- 5b: play -------------------------------------------------------------
  ok = torch.ones((), dtype=torch.bool, device=env.device)
  nan_count = torch.zeros((), dtype=torch.long, device=env.device)
  fell = torch.zeros((), device=env.device)
  resets = torch.zeros((), device=env.device)
  track = []
  per_step = []
  total = {}
  track_params = env.reward_manager.params['track_lin_vel_exp']
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(ENV_STEPS):
    reset_launches()
    obs, rew, term, trunc, extras = env.step(actor(obs))
    per_step.append((LAUNCHES['smooth'], LAUNCHES['newton'],
                     LAUNCHES['pd_solve'], LAUNCHES['contact_rows']))
    ok &= torch.isfinite(rew).all() & torch.isfinite(obs['policy']).all() \
        & torch.isfinite(obs['critic']).all()
    nan_count += extras['Episode_Termination/physics_nan']
    fell += extras['Episode_Termination/fell_over']
    resets += extras['reset_count']
    if i >= ENV_STEPS - 50:
      raw = mdp.track_lin_vel_exp(env._make_ctx(env.state), **track_params)
      done = term | trunc
      track.append(torch.where(done, torch.zeros_like(raw), raw).sum()
                   / (~done).sum())
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  for k3, k2, k1, k4 in per_step:
    for name, n in (('smooth', k3), ('newton', k2), ('pd_solve', k1),
                    ('contact_rows', k4)):
      total[name] = total.get(name, 0) + n
  shapes = sorted(set(per_step))
  print(f'env path launches per env-step (K3, K2, K1, K4): '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }', flush=True)
  check(set(shapes) <= {(4, 4, 8, 4), (5, 5, 9, 5)},
        f'an env-step launched {shapes}, not 4/4/8/4 or 5/5/9/5')
  track_mean = float(torch.stack(track).mean())
  fell_share = float(fell) / B
  print(f'env path: {ENV_STEPS} env-steps x {B} envs under the shipped actor '
        f'in {wall:.3f} s = {ENV_STEPS * B / wall:.1f} env-steps/s '
        f'({wall / ENV_STEPS * 1e3:.2f} ms an env-step); resets '
        f'{int(resets)}, fell_over {int(fell)} ({fell_share:.4f} of envs), '
        f'physics_nan {int(nan_count)}, mean raw track_lin_vel_exp over the '
        f'last 50 steps {track_mean:.4f}; card {card}', flush=True)
  check(bool(ok), 'non-finite observation or reward on the env path')
  check(int(nan_count) == 0, f'physics_nan fired {int(nan_count)} times')
  check(fell_share < 0.05, f'{fell_share:.4f} of envs fell over in '
        f'{ENV_STEPS} steps')
  check(track_mean >= 0.5, f'mean raw track_lin_vel_exp {track_mean:.4f} is '
        'under 0.5')

  # one env tipped over: that env-step resets it and refreshes every env
  tip_over(torch, env, 7)
  reset_launches()
  obs, _, term, _, extras = env.step(actor(obs))
  tipped = (LAUNCHES['smooth'], LAUNCHES['newton'], LAUNCHES['pd_solve'],
            LAUNCHES['contact_rows'])
  print(f'env path, env 7 tipped over: launches {tipped}, terminated '
        f'{bool(term[7])}, reset_count {int(extras["reset_count"])}',
        flush=True)
  check(bool(term[7]) and tipped == (5, 5, 9, 5),
        'a tipped env did not reset with one more forward')
  check((5, 5, 9, 5) in shapes + [tipped], 'no env-step launched 5/5/9/5')

  # the step waits for the card once: the refresh's bool(done.any())
  act = actor(obs)

  def three_steps():
    o = obs
    for _ in range(3):
      o, *_ = env.step(act)
    return o

  obs, syncs = count_syncs(torch, three_steps)
  print(f'env path: {len(syncs)} synchronizing calls in 3 env-steps',
        flush=True)
  check(len(syncs) == 3, 'env.step synchronizes other than once a step: '
        + '; '.join(sorted(set(syncs))))

  # zero actions for contrast
  zero = torch.zeros((B, env.action_dim), device=env.device)
  obs, _ = env.reset()
  zfell = torch.zeros((), device=env.device)
  zrew = torch.zeros((), device=env.device)
  for _ in range(ZERO_STEPS):
    obs, rew, _, _, extras = env.step(zero)
    zfell += extras['Episode_Termination/fell_over']
    zrew += rew.mean()
    ok &= torch.isfinite(rew).all() & torch.isfinite(obs['policy']).all()
  ztrack = float(mdp.track_lin_vel_exp(env._make_ctx(env.state),
                                       **track_params).mean())
  print(f'env path, zero actions: {ZERO_STEPS} env-steps, fell_over '
        f'{int(zfell)}, mean reward a step {float(zrew) / ZERO_STEPS:.5f}, '
        f'raw track_lin_vel_exp at the end {ztrack:.4f}', flush=True)
  check(bool(ok), 'non-finite observation or reward under zero actions')

  # ---- 5c: the card against the CPU ---------------------------------------
  e_obs, e_rew, same, n_reset = env_card_vs_cpu(torch)
  tol5 = 1e-3
  print(f'env, 8 envs, 5 env-steps, CUDA f32 vs CPU f64: obs '
        f'err/(1+max|cpu|) {e_obs:.3e}, reward {e_rew:.3e} (tolerance '
        f'{tol5:g}), done flags equal {same}, resets {n_reset}', flush=True)
  check(e_obs <= tol5 and e_rew <= tol5 and same and n_reset >= 1,
        'the env on the card disagrees with the CPU')

  # ---- 5d: one env-step stage by stage --------------------------------------
  obs, _ = env.reset()
  for _ in range(3):
    obs, *_ = env.step(actor(obs))
  runs = []
  for _ in range(5):
    timer = StageTimer(torch)
    torch.cuda.synchronize()
    with timer('actor'):
      act = actor(obs)
    env._state, out = env.step_fn(env.state, act, stage=timer)
    obs = out[0]
    runs.append(timer)
  for name in runs[0].gpu:
    g = statistics.median(r.gpu.get(name, 0.0) for r in runs)
    h = statistics.median(r.host.get(name, 0.0) for r in runs)
    print(f'env-step stage {name}: {g:.3f} ms between events, {h:.3f} ms '
          f'host issue (median of 5, {B} envs, {card})', flush=True)
  return total


def train_card_vs_cpu(torch, num_envs: int = 8, steps: int = 4):
  """One learn iteration of the G1 flat env under the degenerate-range
  configuration, `clip_actions=0.0` (every action exactly 0, so no noise
  draw matters), the 'fixed' schedule and one minibatch, on the card in
  float32 against the port on the CPU with the env in float64 (the
  learner is float32 on both); the same initial parameters, one env
  tipped over so that an episode ends in the rollout. Returns ({name:
  err/(1+max|cpu|)} of the rollout buffers, advantages, returns and
  losses, whether the done flags agreed, dones seen, max |param diff|,
  share of parameter elements that differ by more than lr / 10, Adam
  steps, lr)."""
  from mjlab_torch.rl.ppo import PPO
  from mjlab_torch.tasks import registry
  ppos, states, logs = [], [], []
  for dev, dt in (('cuda', torch.float32), ('cpu', torch.float64)):
    env = registry.make(
        ENV_TASK, cfg=degenerate_ranges(registry.load_cfg(ENV_TASK), num_envs),
        device=dev, dtype=dt)
    cfg = registry.load_cfg(ENV_TASK, 'rl_cfg_entry_point')
    cfg.device, cfg.num_steps_per_env, cfg.clip_actions = dev, steps, 0.0
    cfg.algorithm.schedule, cfg.algorithm.num_mini_batches = 'fixed', 1
    ppo = PPO(env, cfg)
    ts = ppo.init_state()
    ts.env_state = tip_over_state(torch, ts.env_state, 1)
    ppos.append(ppo)
    states.append(ts)
  with torch.no_grad():
    for k, p in states[1].net.named_parameters():
      p.copy_(states[0].net.get_parameter(k).cpu())
  for ppo, ts in zip(ppos, states):
    logs.append(ppo._learn_iteration(ts)[1])
  (gp, cp), (gs, cs) = ppos, states
  pairs = {k: (getattr(gp.storage, k), getattr(cp.storage, k)) for k in (
      'actor_obs', 'critic_obs', 'action', 'logprob', 'mean', 'value',
      'reward')}
  pairs['advantages'] = (gp.advantages, cp.advantages)
  pairs['returns'] = (gp.returns, cp.returns)
  pairs.update({k: (logs[0][k], logs[1][k]) for k in ('loss', 'pg', 'v',
                                                       'ent', 'kl')})
  errs = {k: rel_err(a.cpu(), b) for k, (a, b) in pairs.items()}
  flags = all(torch.equal(getattr(gp.storage, k).cpu(),
                          getattr(cp.storage, k)) for k in ('done', 'time_out'))
  dones = int(cp.storage.done.sum())
  diffs = [(p.detach().cpu() - cs.net.get_parameter(k).detach()).abs()
           for k, p in gs.net.named_parameters()]
  lr = cfg.algorithm.learning_rate
  max_diff = max(float(d.max()) for d in diffs)
  share = (sum(int((d > lr / 10).sum()) for d in diffs)
           / sum(d.numel() for d in diffs))
  n_steps = cfg.algorithm.num_learning_epochs
  return errs, flags, dones, max_diff, share, n_steps, lr


class _PerStep(list):
  """Each env-step's launches, and `envs`: the envs that stepped."""

  def __init__(self):
    super().__init__()
    self.envs = set()


@contextlib.contextmanager
def counted(total):
  """Within the block the kernels' launch counts start from 0; at its end
  they are added to `total` (a Counter). Kernel calls outside such blocks
  (a stage run alone, a kernel against its plain version) count for no
  path."""
  from mjlab_torch.ops import LAUNCHES, reset_launches
  reset_launches()
  yield
  total.update(LAUNCHES)


@contextlib.contextmanager
def launches_per_step(kernels):
  """Within the block, every env-step of any env (ManagerBasedRlEnv's
  `_step_fn`) appends its launches of `kernels` to the yielded list, and
  adds its env's (num_envs, device type) to the list's `envs`."""
  from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnv
  from mjlab_torch.ops import LAUNCHES
  per_step = _PerStep()
  plain_step = ManagerBasedRlEnv._step_fn

  def counted_step(self, *a, **kw):
    before = [LAUNCHES[k] for k in kernels]
    out = plain_step(self, *a, **kw)
    per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
    per_step.envs.add((self.num_envs, self.device.type))
    return out

  ManagerBasedRlEnv._step_fn = counted_step
  try:
    yield per_step
  finally:
    ManagerBasedRlEnv._step_fn = plain_step


def train_path(torch, card: str, keep: 'dict | None' = None) -> dict:
  """Phase 6: the training path at 4096 envs. Returns the kernels' launches
  over the 3 iterations of `train.main` (env build and reset included).
  With `keep` (a dict holding 'dir', a directory the caller removes), 6a's
  checkpoint is copied there as keep['ckpt'] and its collection times an
  iteration go to keep['collection_ms'], for phase 17a."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_train_')
  try:
    return _train_path(torch, card, root, keep)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _train_path(torch, card: str, root: str, keep=None) -> dict:
  import math
  import os

  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.rl.runner import OnPolicyRunner
  from mjlab_torch.scripts import play, train

  argv = [ENV_TASK, '--log-root', root, '--env.scene.num_envs', str(B)]

  # ---- 6a: 3 iterations through the entry point ----------------------------
  with launches_per_step(('smooth', 'newton', 'pd_solve',
                          'contact_rows')) as per_step:
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    runner = train.main(argv + ['--agent.max_iterations', str(TRAIN_ITERS),
                                '--run-name', 'a'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
  cfg, env = runner.cfg, runner.env
  T = cfg.num_steps_per_env
  print(f'train path: {TRAIN_ITERS} iterations of {T} env-steps x {B} envs '
        f'through train.main in {wall:.2f} s (env build included); widths '
        f'actor {cfg.policy.actor_hidden_dims} critic '
        f'{cfg.policy.critic_hidden_dims}, {cfg.algorithm.num_learning_epochs}'
        f' epochs x {cfg.algorithm.num_mini_batches} minibatches; launches '
        f'{launches}', flush=True)
  check(env.device.type == 'cuda' and env.num_envs == B,
        'the training env is not 4096 envs on the card')
  shapes = sorted(set(per_step))
  print(f'train path launches per rollout env-step (K3, K2, K1, K4): '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }', flush=True)
  check(len(per_step) == TRAIN_ITERS * T,
        f'{len(per_step)} env-steps, not {TRAIN_ITERS * T}')
  check(set(shapes) <= {(4, 4, 8, 4), (5, 5, 9, 5)},
        f'a rollout env-step launched {shapes}, not 4/4/8/4 or 5/5/9/5')

  run = os.path.join(root, cfg.experiment_name, 'a')
  with open(os.path.join(run, 'metrics.jsonl')) as f:
    lines = [json.loads(line) for line in f]
  check([l_['iteration'] for l_ in lines] == [1, TRAIN_ITERS],
        f'metrics.jsonl holds iterations {[l_["iteration"] for l_ in lines]}')
  for l_ in lines:
    print(f'train path iteration {l_["iteration"]}: collection '
          f'{l_["collection_ms"]:.1f} ms, learning {l_["learning_ms"]:.1f} ms, '
          f'resets {l_["resets"]:.0f}, physics_nan '
          f'{l_["Episode_Termination/physics_nan"]:.0f}, fell_over '
          f'{l_["Episode_Termination/fell_over"]:.0f}, loss {l_["loss"]:.4f} '
          f'pg {l_["pg"]:.5f} v {l_["v"]:.4f} ent {l_["ent"]:.4f} kl '
          f'{l_["kl"]:.5f} std {l_["std"]:.4f} lr {l_["lr"]:.3e}, mean reward '
          f'{l_["mean_reward"]:.4f}, episode length '
          f'{l_["mean_episode_length"]:.2f}; card {card}', flush=True)
    check(all(math.isfinite(l_[k]) for k in ('loss', 'pg', 'v', 'ent', 'kl',
                                              'std')),
          f'non-finite loss logs at iteration {l_["iteration"]}')
    # the bounds as the float32 learning rate holds them
    lr_lo, lr_hi = float(torch.tensor(1e-5)), float(torch.tensor(1e-2))
    check(lr_lo <= l_['lr'] <= lr_hi, f'lr {l_["lr"]} outside [1e-5, 1e-2]')
  last = lines[-1]
  print(f'train path: {TRAIN_ITERS * T * B / last["wall_s"]:.1f} training '
        f'env-steps/s ({TRAIN_ITERS} x {T} x {B} over {last["wall_s"]:.3f} s '
        f'of learn); card {card}', flush=True)

  ckpt = os.path.join(run, f'model_{TRAIN_ITERS}.pt')
  check(os.path.exists(ckpt), f'{ckpt} was not written')
  if keep is not None:
    import shutil
    keep['ckpt'] = shutil.copy(ckpt, keep['dir'])
    keep['collection_ms'] = [l_['collection_ms'] for l_ in lines]
  onnx_check(torch, runner, ckpt, 'train path')
  net0 = runner.alg.init_net(torch.Generator(device=env.device).manual_seed(
      cfg.seed + 1))
  moved = []
  for k, p in runner.ts.net.named_parameters():
    p0 = net0.get_parameter(k)
    check(bool(torch.isfinite(p).all()), f'parameter {k} is not finite')
    check(not torch.equal(p, p0), f'parameter {k} did not move')
    moved.append(float((p != p0).float().mean()))
  print(f'train path: every parameter finite and moved (share of elements '
        f'moved: min {min(moved):.4f})', flush=True)

  # ---- 6b: the checkpoint into a fresh runner, bit for bit; a resumed run --
  fresh = OnPolicyRunner(env, cfg)
  fresh.load(ckpt)
  a, b = runner.ts, fresh.ts
  same = (a.iteration == b.iteration == TRAIN_ITERS and torch.equal(a.lr, b.lr)
          and torch.equal(a.adam.count, b.adam.count)
          and all(torch.equal(p, b.net.get_parameter(k))
                  and torch.equal(a.adam.mu[k], b.adam.mu[k])
                  and torch.equal(a.adam.nu[k], b.adam.nu[k])
                  for k, p in a.net.named_parameters()))
  print(f'train path: {ckpt.split(os.sep)[-1]} loads into a fresh runner bit '
        f'for bit: {same}', flush=True)
  check(same, 'the checkpoint did not load bit for bit')
  del fresh

  # what one rollout and one update wait for
  alg, ts = runner.alg, runner.ts
  (traj, last_value, _, _), roll_syncs = count_syncs(
      torch, lambda: alg._rollout(ts))

  def learn():
    adv, ret = alg._gae(traj, last_value)
    return alg._update(ts, traj, adv, ret)

  _, upd_syncs = count_syncs(torch, learn)
  torch.cuda.synchronize()
  print(f'train path: {len(roll_syncs)} synchronizing calls in a rollout of '
        f'{T} env-steps, {len(upd_syncs)} in GAE and the update '
        f'{sorted(set(upd_syncs))}', flush=True)
  check(len(roll_syncs) == T, 'the rollout synchronizes other than once an '
        'env-step: ' + '; '.join(sorted(set(roll_syncs))))
  del runner, alg, ts, traj, last_value, env

  resumed = train.main(argv + ['--agent.max_iterations', '1', '--run-name',
                               'b', '--resume'])
  ckpt4 = os.path.join(root, cfg.experiment_name, 'b',
                       f'model_{TRAIN_ITERS + 1}.pt')
  print(f'train path: resumed from iteration {TRAIN_ITERS}, wrote '
        f'{ckpt4.split(os.sep)[-1]}: {os.path.exists(ckpt4)}', flush=True)
  check(resumed.ts.iteration == TRAIN_ITERS + 1 and os.path.exists(ckpt4),
        'the resumed run did not write its checkpoint')
  del resumed

  # ---- 6c: the card against the CPU -----------------------------------------
  errs, flags, dones, max_diff, share, n_steps, lr = train_card_vs_cpu(torch)
  worst_key = max(errs, key=errs.get)
  worst = errs[worst_key]
  tol6 = 1e-3
  print(f'train, 8 envs x 4 env-steps, one learn iteration, CUDA f32 vs CPU '
        f'(env f64): rollout buffers, advantages, returns and losses '
        f'err/(1+max|cpu|) worst {worst:.3e} ({worst_key}; '
        + ', '.join(f'{k} {v:.1e}' for k, v in errs.items())
        + f'; tolerance {tol6:g}), done flags equal '
        f'{flags}, dones {dones}; parameters after {n_steps} Adam steps: max '
        f'|diff| {max_diff:.3e} (tolerance 2 lr x steps = '
        f'{2 * lr * n_steps:g}), share over lr/10 {share:.2e} (tolerance '
        f'0.01)', flush=True)
  check(worst <= tol6 and flags and dones >= 1,
        'the learner on the card disagrees with the CPU')
  check(max_diff <= 2 * lr * n_steps + 1e-6 and share <= 0.01,
        'the parameters after the update disagree with the CPU')

  # ---- 6d: play the checkpoint ----------------------------------------------
  stats = play.main([ENV_TASK + '-Play', '--checkpoint', ckpt, '--steps',
                     '20'])
  check(math.isfinite(stats['mean_reward']), 'play gave a non-finite reward')
  return launches


FLIP_GAP = 1e-6  # m: a contact this close to its threshold may flip in f32


def card_vs_cpu_flips(torch, task: str, make_cfg, steps: int,
                      values=None):
  """The env of `task` with the cfg `make_cfg()` builds (its sampling
  ranges collapsed to a point) on the card in float32 against the port on
  the CPU in float64, the same actions from numpy's default_rng(0), and
  `values(model)` (per-env model fields as numpy, drawn once from the CPU
  env's Model) written into both models.

  A contact that lies within float32 rounding of its threshold may be
  active on one side and not on the other; from that substep on the two
  follow different branches of the contact dynamics. Every substep's
  active contacts are recorded on both sides: an env in which they first
  differ in env-step i is compared up to env-step i - 1, and the flip is
  returned with its contact's distance to the threshold on the CPU.
  Returns (worst observation err/(1+max|cpu|), worst reward
  err/(1+max|cpu|), whether every compared done flag agreed, {env:
  (env-step of its flip, |dist - includemargin| there)}, envs compared to
  the end)."""
  import numpy as np
  from mjlab_torch.physics import pipeline
  from mjlab_torch.tasks import registry
  envs = [registry.make(task, cfg=make_cfg(), device=dev, dtype=dt)
          for dev, dt in (('cuda', torch.float32), ('cpu', torch.float64))]
  for env in envs:
    env.reset()
  if values is not None:
    vals = values(envs[1].scene.model)
    for env in envs:
      st = env.state
      env._state = st.replace(model=st.model.replace(**{
          f: torch.as_tensor(v, dtype=st.model.dtype, device=env.device)
          for f, v in vals.items()}))
  num_envs = envs[1].num_envs
  substeps = envs[1].cfg.decimation
  # each substep's contacts, by device: (active, dist - includemargin)
  contacts = {'cuda': [], 'cpu': []}
  plain_step = pipeline.step

  def recording_step(m, d):
    out = plain_step(m, d)
    c = out.contact
    contacts[out.qpos.device.type].append(
        ((c.dist < c.includemargin).cpu(),
         (c.dist - c.includemargin).double().cpu()))
    return out

  worst_obs, worst_rew, flags_equal = 0.0, 0.0, True
  flips = {}
  keep = torch.ones(num_envs, dtype=torch.bool)
  rng = np.random.default_rng(0)
  pipeline.step = recording_step
  try:
    for i in range(steps):
      act = 0.3 * rng.normal(size=(num_envs, envs[1].action_dim))
      outs = [env.step(torch.as_tensor(act, dtype=env.state.actions.dtype,
                                       device=env.device)) for env in envs]
      for (a_card, _), (a_cpu, gap) in zip(contacts['cuda'][-substeps:],
                                           contacts['cpu'][-substeps:]):
        differ = a_card != a_cpu
        for e in torch.nonzero(differ.any(-1) & keep).flatten().tolist():
          flips[e] = (i, float(gap[e][differ[e]].abs().max()))
          keep[e] = False
      (go, gr, gt, gc, _), (co, cr, ct, cc, _) = outs
      worst_obs = max([worst_obs] + [rel_err(go[g].cpu()[keep], co[g][keep])
                                     for g in co])
      worst_rew = max(worst_rew, rel_err(gr.cpu()[keep], cr[keep]))
      flags_equal &= bool((gt.cpu() == ct)[keep].all()) and bool(
          (gc.cpu() == cc)[keep].all())
  finally:
    pipeline.step = plain_step
  return worst_obs, worst_rew, flags_equal, flips, int(keep.sum())


def task_card_vs_cpu(torch, task: str, num_envs: int = 8, steps: int = 5):
  """The env of `task`, its sampling ranges collapsed to a point, on the
  card against the CPU (card_vs_cpu_flips); phases 8d and 10e."""
  from mjlab_torch.tasks import registry
  return card_vs_cpu_flips(
      torch, task,
      lambda: degenerate_ranges(registry.load_cfg(task), num_envs), steps)


def config5_card_vs_cpu(torch, num_envs: int = 8, steps: int = 6):
  """Config 5's env under the degenerate-range configuration on the card
  against the CPU (card_vs_cpu_flips), the same distinct per-env values of
  its three randomized fields written into both models
  (distinct_dr_values)."""
  from mjlab_torch.envs import mdp as env_mdp
  from mjlab_torch.managers import term_cfg
  from mjlab_torch.tasks import registry

  def make_cfg():
    return full_dr_history(degenerate_ranges(registry.load_cfg(ENV_TASK),
                                             num_envs), env_mdp, term_cfg)

  return card_vs_cpu_flips(
      torch, ENV_TASK, make_cfg, steps,
      values=lambda model: distinct_dr_values(model, num_envs))


def config5_path(torch, card: str) -> dict:
  """Phase 7: the G1 velocity shape of BASELINE config 5 (observation
  history 5; foot friction, pelvis mass and joint damping randomized per
  env at startup) at 4096 envs through `registry.make` and the PPO runner
  at the registered widths. Returns the kernels' launches over its env-steps
  and its training iterations."""
  import math

  from mjlab_torch.envs import mdp as env_mdp
  from mjlab_torch.managers import term_cfg
  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.ops import smooth_kernel as k_smooth
  from mjlab_torch.rl.runner import make_runner
  from mjlab_torch.tasks import registry

  # ---- 7a: build the env; its per-env model fields and observation --------
  t0 = time.perf_counter()
  cfg = full_dr_history(registry.load_cfg(ENV_TASK), env_mdp, term_cfg)
  cfg.scene.num_envs = B
  env = registry.make(ENV_TASK, cfg=cfg)  # cuda, float32
  torch.cuda.synchronize()
  print(f'config 5: built {B} envs in {time.perf_counter() - t0:.2f} s, per-'
        f'env fields {env.per_env_fields}, obs {env.observation_dims}',
        flush=True)
  m, base = env.model, env.scene.model
  check(env.per_env_fields == sorted(DR_FIELDS),
        f'per-env fields {env.per_env_fields}')
  for f in DR_FIELDS:
    want = (B,) + tuple(getattr(base, f).shape)
    check(tuple(getattr(m, f).shape) == want,
          f'{f} has shape {tuple(getattr(m, f).shape)}, not {want}')
  view = env.scene['robot']
  pelvis = int(view.idx.body_ids[list(view.idx.body_names).index('pelvis')])
  ratio = m.body_mass[:, pelvis] / base.body_mass[pelvis]
  others = torch.arange(base.body_mass.shape[0], device=m.body_mass.device)
  others = others != pelvis
  fric = m.geom_friction[:, :, 0]
  feet = (fric != base.geom_friction[:, 0]).any(0)
  f0 = fric[:, feet]
  damp_ok = bool(((m.dof_damping >= 0.8 * base.dof_damping)
                  & (m.dof_damping <= 1.2 * base.dof_damping)).all())
  print(f'config 5: pelvis mass x[{float(ratio.min()):.4f}, '
        f'{float(ratio.max()):.4f}] (std {float(ratio.std()):.4f}) of '
        f'{float(base.body_mass[pelvis]):.4f} kg; dof damping in [0.8, 1.2] '
        f'x compiled: {damp_ok} (compiled damping max '
        f'{float(base.dof_damping.max()):.4f}); {int(feet.sum())} foot geoms, '
        f'friction [{float(f0.min()):.4f}, {float(f0.max()):.4f}] (std '
        f'{float(f0.std()):.4f})', flush=True)
  check(float(ratio.min()) >= 0.9 - 1e-6 and float(ratio.max()) <= 1.1 + 1e-6
        and float(ratio.std()) > 0.02, 'pelvis mass not spread over '
        'x[0.9, 1.1]')
  check(torch.equal(m.body_mass[:, others],
                    base.body_mass[others].expand(B, -1)),
        'a mass other than the pelvis changed')
  check(damp_ok, 'joint damping outside x[0.8, 1.2] of its compiled value')
  check(int(feet.sum()) == 14 and float(f0.min()) >= 0.3
        and float(f0.max()) <= 1.2 and float(f0.std()) > 0.2,
        'foot friction is not spread over [0.3, 1.2]')
  terms = env.observation_manager.groups['policy']
  width = sum(t.dim for t in terms)
  check(all(t.history == HISTORY for t in terms)
        and env.observation_dims['policy'] == HISTORY * width,
        f'policy obs {env.observation_dims["policy"]} is not {HISTORY} x '
        f'{width}')
  plan = k_smooth.plan_of(m)
  check(plan.env_batch == B and plan.dims[15] == 1,
        'K3 does not take config 5\'s bconst per env')

  # ---- 7b: env-steps; launches and waits an env-step ----------------------
  kernels = ('smooth_env', 'newton', 'pd_solve', 'smooth')
  obs, _ = env.reset()
  check(tuple(obs['policy'].shape) == (B, HISTORY * width),
        f'obs policy has shape {tuple(obs["policy"].shape)}')
  agen = torch.Generator(device='cuda').manual_seed(7)
  acts = 0.3 * torch.randn(ENV_STEPS_5, B, env.action_dim, generator=agen,
                           device='cuda')
  per_step = []
  torch.cuda.synchronize()
  reset_launches()
  total = {}
  t0 = time.perf_counter()
  for i in range(ENV_STEPS_5):
    before = [LAUNCHES[k] for k in kernels]
    obs, rew, _, _, extras = env.step(acts[i])
    per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  check(bool(torch.isfinite(obs['policy']).all())
        and bool(torch.isfinite(rew).all()), 'non-finite obs or reward')
  tip_over(torch, env, 1)
  before = [LAUNCHES[k] for k in kernels]
  _, _, term, _, _ = env.step(acts[0])
  per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
  shapes = sorted(set(per_step))
  print(f'config 5: {ENV_STEPS_5} env-steps x {B} envs under random actions '
        f'in {wall:.3f} s = {ENV_STEPS_5 * B / wall:.1f} env-steps/s '
        f'({wall / ENV_STEPS_5 * 1e3:.2f} ms an env-step); launches per '
        f'env-step (K3 per env, K2, K1, K3 shared): '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }; card {card}',
        flush=True)
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)},
        f'an env-step launched {shapes}, not 4/4/8 or 5/5/9 with K3 per env')
  check(bool(term[1]) and per_step[-1] == (5, 5, 9, 0),
        'a tipped env did not reset with one more forward')
  act = acts[1]

  def three_steps():
    for _ in range(3):
      env.step(act)

  _, syncs = count_syncs(torch, three_steps)
  print(f'config 5: {len(syncs)} synchronizing calls in 3 env-steps',
        flush=True)
  check(len(syncs) == 3, 'env.step synchronizes other than once a step: '
        + '; '.join(sorted(set(syncs))))

  # ---- 7c: PPO through the runner at the registered widths ----------------
  agent = registry.load_cfg(ENV_TASK, 'rl_cfg_entry_point')
  runner = make_runner(env, agent)
  net0 = {k: p.detach().clone() for k, p in runner.ts.net.named_parameters()}
  T = agent.num_steps_per_env
  learn_s = 0.0
  for _ in range(TRAIN_ITERS):
    logs = runner.learn(1, log_every=1)
    learn_s += logs['wall_s']
    print(f'config 5 iteration {logs["iteration"]}: collection '
          f'{logs["collection_ms"]:.1f} ms, learning {logs["learning_ms"]:.1f}'
          f' ms, resets {logs["resets"]:.0f} (fell_over '
          f'{logs["Episode_Termination/fell_over"]:.0f}, time_out '
          f'{logs["Episode_Termination/time_out"]:.0f}, physics_nan '
          f'{logs["Episode_Termination/physics_nan"]:.0f}), loss '
          f'{logs["loss"]:.4f} kl {logs["kl"]:.5f} std {logs["std"]:.4f}, '
          f'mean reward {logs["mean_reward"]:.4f}; card {card}', flush=True)
    check(all(math.isfinite(logs[k]) for k in ('loss', 'pg', 'v', 'ent',
                                               'kl', 'std')),
          f'non-finite loss logs at iteration {logs["iteration"]}')
    check(logs['Episode_Termination/physics_nan'] == 0,
          'physics_nan fired in training')
  for k, p in runner.ts.net.named_parameters():
    check(bool(torch.isfinite(p).all()), f'parameter {k} is not finite')
    check(not torch.equal(p, net0[k]), f'parameter {k} did not move')
  torch.cuda.synchronize()
  launches = dict(LAUNCHES)
  print(f'config 5: {TRAIN_ITERS * T * B / learn_s:.1f} training env-steps/s '
        f'({TRAIN_ITERS} x {T} x {B} over {learn_s:.3f} s of learn); every '
        f'parameter finite and moved; launches over the path {launches}; '
        f'card {card}', flush=True)
  check(launches.get('smooth', 0) == 0, 'config 5 launched K3\'s shared '
        'form')
  del runner, env

  # ---- 7d: the card against the CPU ---------------------------------------
  e_obs, e_rew, same, flips, kept = config5_card_vs_cpu(torch)
  tol7 = 1e-3
  print(f'config 5, 8 envs, 6 env-steps, the same per-env values, CUDA f32 '
        f'vs CPU f64: obs err/(1+max|cpu|) {e_obs:.3e}, reward {e_rew:.3e} '
        f'(tolerance {tol7:g}), done flags equal {same}; contact flips '
        f'(env: env-step, |dist - margin| on the CPU in m) '
        f'{ {e: (i, f"{g:.3e}") for e, (i, g) in flips.items()} } '
        f'(allowed within {FLIP_GAP:g} m of the threshold), {kept} envs '
        f'compared to the end', flush=True)
  check(e_obs <= tol7 and e_rew <= tol7 and same,
        'config 5 on the card disagrees with the CPU')
  check(all(g <= FLIP_GAP for _, g in flips.values()) and kept >= 6,
        'a contact flipped between the card and the CPU away from its '
        'threshold, or in more than two envs')
  return launches


def onnx_check(torch, runner, path: str, what: str) -> float:
  """The deployment ONNX the runner wrote beside the checkpoint `path`
  (its .onnx and .onnx.meta.json) read back by parse_model and evaluated
  in numpy on 256 of the rollout's observations, against the runner's
  inference policy on the card. The tasks train without observation
  normalization, so the graph's normalizer must be the identity; the
  metadata's joints are the action term's. Returns the error over
  (1 + max |actions|)."""
  import os

  import numpy as np
  from mjlab_torch.rl import onnx_writer
  onnx = os.path.splitext(path)[0] + '.onnx'
  check(os.path.exists(onnx) and os.path.exists(onnx + '.meta.json'),
        f'{what}: {onnx} or its sidecar was not written')
  parsed = onnx_writer.parse_model(onnx)
  with open(onnx + '.meta.json') as f:
    meta = json.load(f)
  alg = runner.alg
  obs = {k: v[:256] for k, v in runner.ts.obs.items()}
  want = runner.get_inference_policy()(obs).double().cpu()
  got = onnx_writer.run_mlp_policy(
      parsed, alg._cat_obs(obs, alg.actor_groups).cpu().numpy())
  err = float((torch.as_tensor(got).double() - want).abs().max()) / scale(
      want)
  init = parsed['initializers']
  identity = bool((init['obs_mean'] == 0).all() and (init['obs_std'] == 1)
                  .all())
  joints = list(runner.env.action_manager.terms['joint_pos'].joint_names)
  print(f'{what}: {os.path.basename(onnx)} nodes '
        f'{[n["op_type"] for n in parsed["nodes"]]}, graph in numpy vs the '
        f'inference policy on the card, 256 observations: err/(1+max|a|) '
        f'{err:.3e} (tolerance 1e-4); identity normalizer {identity}; '
        f'{len(meta["joint_names"])} joints in the metadata', flush=True)
  check(not runner.cfg.policy.actor_obs_normalization,
        f'{what}: the task trains with normalization; the check expects an '
        'identity normalizer')
  check(err <= 1e-4, f'{what}: the ONNX graph disagrees with the policy')
  check(identity, f'{what}: the ONNX graph folds in a normalizer the policy '
        'does not use')
  check(meta['joint_names'] == joints,
        f'{what}: the ONNX metadata names other joints than the action term')
  return err


# phase 2f's envs, the benchmark's training cell's. K4 serves every path
# but five: the Go1 flat and Tiny scenes, the oracle models and the pile
# do not compact their contacts, and the elliptic cone builds its rows in
# the plain version
K4_ENVS = 16384


def k4_numbers(torch, phys, mj, card: str, busy) -> dict:
  """Phase 2f: K4 on K4_ENVS G1 flat envs dropped onto the floor, against
  its plain version (the c block, c_D masked as make_efc leaves it), timed
  alone on the pools' selection and beside its plain version and the whole
  kernel path (selection and kernel); its row of the kernels line."""
  from mjlab_torch.ops import contact_rows as k_rows
  from mjlab_torch.ops.work import bound_ms, contact_rows_work
  from mjlab_torch.physics import constraint, pipeline
  from mjlab_torch.physics.tables import ix, table
  m = phys.put_model(mj)
  s = m.stat
  gen = torch.Generator().manual_seed(23)
  d = pipeline.fwd_position(m, g1_states(torch, phys, mj, m, K4_ENVS, 0.03,
                                         gen))
  ts = m.opt.timestep
  check(constraint.contact_rows_takes(m, d), 'K4 refuses the G1 flat scene')
  got, _ = constraint._contacts_kernel(m, d, ts, True)
  want = list(constraint.contacts_compacted_plain(m, d, ts, True)[0])
  want[1] = torch.where(want[3], want[1], 0.0)
  exact = torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
  errs = {k: max_err(g, w) for k, g, w in zip(('J', 'D', 'aref'), got, want)}
  worst = max(rel_err(g, w) for g, w in zip(got[:3], want[:3]))
  tol = 1e-5
  print(f'K4 contact_rows at {K4_ENVS} envs: c_active and c_pos equal: '
        f'{exact}; max abs err J {errs["J"]:.3e}, D {errs["D"]:.3e}, aref '
        f'{errs["aref"]:.3e}; worst err/(1+max|plain|) {worst:.3e} '
        f'(tolerance {tol:g}); {int(want[3].sum())} active rows of '
        f'{want[3].numel()}', flush=True)
  check(exact and worst <= tol, 'K4 disagrees with its plain version')

  # the kernel alone, on the selection the kernel path makes
  con = d.contact
  dev = d.qpos.device
  tab, dim, ancd, np3 = constraint._pool_tables(s)
  sl3, sl1 = constraint.compaction_slot_pools(s)
  pdist = con.dist - con.includemargin
  sel3 = constraint.deepest(pdist[:, ix(sl3, dev)], s.ncon_cap)
  sel1 = constraint.deepest(pdist[:, ix(sl1, dev)], s.ncon_cap1)
  A = constraint._pyramid_axes(s)
  kargs = (pdist, sel3, sel1, con.pos, con.frame, con.friction, con.solref,
           con.solimp, d.cdof, d.subtree_com, d.qvel, m.body_invweight0, ts,
           m.opt.impratio, table(tab, torch.int32, dev),
           table(dim, torch.int32, dev), table(ancd, torch.int8, dev))
  kw = dict(np3=np3, A=A, refsafe=True)
  alone = lambda: k_rows.contact_rows_cuda(*kargs, **kw)
  ms = time_ms(torch, alone, 20)
  dev_ms = time_ms(torch, alone, 20, busy=busy)
  path_ms = time_ms(
      torch, lambda: constraint._contacts_kernel(m, d, ts, True), 20)
  plain_ms = time_ms(
      torch, lambda: constraint.contacts_compacted_plain(m, d, ts, True), 5)
  nbytes, flops = contact_rows_work(K4_ENVS, s.nv, s.nbody, s.ncon_cap,
                                    s.ncon_cap1, A, len(tab))
  bound, by = bound_ms(nbytes, flops)
  print(f'K4 contact_rows: {ms:.4f} ms, {dev_ms:.4f} ms behind a busy card '
        f'({dev_ms / bound:.2f}x its bound {bound:.5f} ms by {by}: '
        f'{nbytes / 1e6:.1f} MB); with the pools\' selection {path_ms:.4f} '
        f'ms; plain {plain_ms:.4f} ms; '
        f'{k_rows.smem_bytes(s.nv, s.ncon_cap, s.ncon_cap1, A)} B of shared '
        f'memory a block; card {card}', flush=True)
  return dict(name='contact_rows (K4)', route='cuda',
              source='mjlab_torch/csrc/contact_rows.cu', replaces=None,
              kernel='contact_rows', max_abs_err=max(errs.values()), ms=ms,
              device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
              bound_by=by, library_ms=None, path_ms=path_ms)


def go1_kernels(torch, card: str, busy) -> dict:
  """Phase 2e: K1-K3 at the Go1's shapes (n = 18, 14 bodies, 57
  uncompacted contact slots, 228 pyramid rows) on 4096 Go1 floor states
  (go1_floor_states: a third of the trunks lying flat, so the plane-box
  pair is active), each against its plain version and timed as in
  phase 2. Returns {kernel: its numbers}."""
  import numpy as np

  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import go1_flat_arrays

  arrays = go1_flat_arrays()
  m = phys.put_model(arrays)
  qpos, qvel = go1_floor_states(arrays.key_qpos[0], m.stat.nv, B, seed=5)
  f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device='cuda')
  d = phys.make_batched_data(m, B).replace(
      qpos=f32(qpos), qvel=f32(qvel),
      ctrl=f32(np.tile(arrays.key_ctrl[0], (B, 1))))
  return shape_kernels(torch, card, busy, 'Go1', m, d, (18, 228, 12))


def shape_kernels(torch, card: str, busy, what: str, m, d,
                  widths: tuple, box: bool = True) -> dict:
  """K1-K3 at the shapes of the model `m` on the float32 batch `d` (with
  `box`, its plane-box pair active in some envs), each against its plain
  version with the tolerances of phase 2 and timed as there; `widths` the
  (n, ncr, nl) K2 must take. Returns {kernel: its numbers}."""
  from mjlab_torch.ops import newton as k_newton
  from mjlab_torch.ops import smooth_kernel as k_smooth
  from mjlab_torch.ops.work import bound_ms, k3_work, pd_solve_work
  from mjlab_torch.physics import constraint, pipeline, smooth
  from mjlab_torch.physics import smooth_fused, solver
  from mjlab_torch.physics.types import GeomType

  s = m.stat
  nb = d.qpos.shape[0]
  out = {}

  # K3
  check(smooth_fused.enabled(s), f'K3 refuses the {what}')
  kern = k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel)
  plain = smooth_fused.plain_all(m, d)
  err = k3_max_err(kern, plain, s.nsite)
  rel = k3_rel_err(torch, kern, plain, s.nsite)
  check(rel <= 1e-4, f'K3 disagrees with its plain version on the {what}: '
        f'{rel:.3e}')
  call = lambda: k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel)
  bound, by = bound_ms(*k3_work(m, d.qpos, d.qvel, kern))
  epb = k_smooth.plan_of(m).fits[k_smooth.ENVS_PER_BLOCK]
  out['smooth'] = dict(
      max_abs_err=err, rel_err=rel, ms=time_ms(torch, call, 20),
      device_ms=time_ms(torch, call, 20, busy=busy),
      plain_ms=time_ms(torch, lambda: smooth_fused.plain_all(m, d), 5),
      bound_ms=bound, bound_by=by, library_ms=None, envs_per_block=epb,
      smem_bytes=k_smooth.smooth_smem_bytes(m, epb))

  # K2
  df = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  df = smooth.fwd_smooth(m, smooth.actuation(m, df))
  efc = constraint.make_efc(m, df)
  n, ncr, nl = s.nv, efc['c_J'].shape[1], efc['l_sign'].shape[1]
  box_envs = 0
  if box:
    at = s.pairs.groups[(int(GeomType.PLANE), int(GeomType.BOX))][3]
    box_envs = int(efc['c_active'][:, 4 * at:4 * at + 16].any(-1).sum())
  print(f'{what} K2 input: n {n}, ncr {ncr}, nl {nl}; {box_envs} of {nb} '
        f'envs with active plane-box rows, {int(efc["c_active"].sum())} '
        f'active contact rows in all; K2 needs '
        f'{k_newton.newton_smem_bytes(n, ncr, nl)} B of shared memory a '
        f'block', flush=True)
  check((n, ncr, nl) == widths, f'the {what} rows are not {widths}')
  check(box_envs > 0 or not box,
        f'no active plane-box rows in the {what} K2 input')
  out['newton'] = k2_numbers(torch, busy, m, solver.newton_args(df, efc),
                             f'the {what}')

  # K1 on the implicitfast system
  dfw = pipeline.forward(m, d)
  deriv = m.dof_damping - pipeline._actuator_vel_deriv(m, dfw)
  H = (dfw.qM + m.opt.timestep * torch.diag_embed(deriv)).contiguous()
  g = (dfw.qfrc_smooth + dfw.qfrc_constraint).contiguous()
  out['pd_solve'] = k1_numbers(torch, busy, H, g, f'the {what}')
  for k, v in out.items():
    print(f'{what} {k}: max abs err {v["max_abs_err"]:.3e}, '
          f'err/(1+max|plain|) {v["rel_err"]:.3e}; {v["ms"]:.4f} ms, '
          f'{v["device_ms"]:.4f} ms behind a busy card, plain '
          f'{v["plain_ms"]:.4f} ms, bound {v["bound_ms"]:.5f} ms by '
          f'{v["bound_by"]}'
          + (f', library {v["library_ms"]:.4f} ms'
             if v['library_ms'] is not None else '')
          + f'; card {card}', flush=True)
  return out


def k1_numbers(torch, busy, H, g, what: str) -> dict:
  """K1 on the systems H x = g against its plain version (within 1e-4 of
  (1 + max |plain|)), timed bare, behind a busy card, plain and as
  torch.linalg.solve; the bound of phase 2b."""
  from mjlab_torch.ops import pd_solve as k_pd
  from mjlab_torch.ops.work import bound_ms, pd_solve_work
  from mjlab_torch.physics import linalg
  nb, n = g.shape
  x_k, x_p = k_pd.solve_pd_cuda(H, g), linalg.solve_pd(H, g)
  rel = rel_err(x_k, x_p)
  check(rel <= 1e-4, f'K1 disagrees with its plain version on {what}: '
        f'{rel:.3e}')
  bound, by = bound_ms(*pd_solve_work(H, g))
  return dict(
      max_abs_err=max_err(x_k, x_p), rel_err=rel,
      ms=time_ms(torch, lambda: k_pd.solve_pd_cuda(H, g), 20),
      device_ms=time_ms(torch, lambda: k_pd.solve_pd_cuda(H, g), 20,
                        busy=busy),
      plain_ms=time_ms(torch, lambda: linalg.solve_pd(H, g), 5),
      bound_ms=bound, bound_by=by,
      library_ms=time_ms(torch, lambda: torch.linalg.solve(H, g[..., None]),
                         20))


def go1_card_vs_cpu(torch, num_envs: int = 8, steps: int = 5):
  """Phase 8d: the Go1 flat env on the card against the CPU
  (task_card_vs_cpu)."""
  return task_card_vs_cpu(torch, GO1_TASK, num_envs, steps)


def go1_path(torch, card: str) -> dict:
  """Phase 8: the Go1 flat velocity task. Returns the kernels' launches
  over its env-steps (8b) and its demo (8c)."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_go1_')
  try:
    return _go1_path(torch, card, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _go1_path(torch, card: str, root: str) -> dict:
  import math
  import os

  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.physics import smooth_fused
  from mjlab_torch.physics.types import GeomType
  from mjlab_torch.scripts import demo
  from mjlab_torch.tasks import registry

  kernels = ('smooth', 'newton', 'pd_solve', 'smooth_env')
  torch.cuda.synchronize()
  reset_launches()

  # ---- 8a: build the env; its model's widths -------------------------------
  t0 = time.perf_counter()
  env = registry.make(GO1_TASK, **{'scene.num_envs': B})  # cuda, float32
  obs, _ = env.reset()
  torch.cuda.synchronize()
  s = env.model.stat
  box_key = (int(GeomType.PLANE), int(GeomType.BOX))
  groups = {f'{GeomType(k[0]).name}-{GeomType(k[1]).name}': len(v[0])
            for k, v in s.pairs.groups.items()}
  print(f'Go1: built and reset {B} envs in {time.perf_counter() - t0:.2f} s '
        f'on {env.device}; nq {s.nq} nv {s.nv} nu {s.nu}, '
        f'{s.pairs.ncon_max} contact slots, caps {s.ncon_cap}/{s.ncon_cap1}, '
        f'pair groups {groups}; obs {env.observation_dims}, actions '
        f'{env.action_dim}', flush=True)
  check(env.device.type == 'cuda', 'the Go1 env is not on the card')
  check((s.nv, s.pairs.ncon_max, s.ncon_cap, s.ncon_cap1) == (18, 57, 0, 0)
        and box_key in s.pairs.groups, 'the Go1 model is not nv 18 with 57 '
        'uncompacted slots and the plane-box pair')
  check(smooth_fused.enabled(s), 'K3 refuses the Go1')
  box = s.pairs.groups[box_key][3]

  # ---- 8b: env-steps under random actions; launches and waits --------------
  agen = torch.Generator(device='cuda').manual_seed(8)
  acts = torch.randn(GO1_STEPS, B, env.action_dim, generator=agen,
                     device='cuda')
  ok = torch.ones((), dtype=torch.bool, device='cuda')
  nan_count = torch.zeros((), dtype=torch.long, device='cuda')
  resets = torch.zeros((), device='cuda')
  box_steps = torch.zeros((), dtype=torch.long, device='cuda')
  per_step = []
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(GO1_STEPS):
    before = [LAUNCHES[k] for k in kernels]
    obs, rew, _, _, extras = env.step(acts[i])
    per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
    ok &= torch.isfinite(obs['policy']).all() & torch.isfinite(rew).all()
    nan_count += extras['Episode_Termination/physics_nan']
    resets += extras['reset_count']
    c = env.state.data.contact
    box_steps += (c.dist < c.includemargin)[:, box:box + 4].any()
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  # env 1 laid on its back, the trunk box flat 2 mm deep in the floor: its
  # substeps take the plane-box rows, and the env-step resets it
  from mjlab_torch.physics import pipeline
  qpos = env.state.data.qpos.clone()
  qpos[1, 2] = 0.048
  qpos[1, 3:7] = torch.tensor([0.0, 1.0, 0.0, 0.0], device=qpos.device)
  env._state = env.state.replace(data=env.state.data.replace(qpos=qpos))
  laid = []
  plain_step = pipeline.step

  def recording_step(m, d):
    out = plain_step(m, d)
    c = out.contact
    laid.append((c.dist < c.includemargin)[1, box:box + 4].all())
    return out

  pipeline.step = recording_step
  try:
    before = [LAUNCHES[k] for k in kernels]
    _, _, term, _, _ = env.step(acts[0])
    per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
  finally:
    pipeline.step = plain_step
  laid = int(torch.stack(laid).sum())
  shapes = sorted(set(per_step))
  print(f'Go1: {GO1_STEPS} env-steps x {B} envs under random actions in '
        f'{wall:.3f} s = {GO1_STEPS * B / wall:.1f} env-steps/s '
        f'({wall / GO1_STEPS * 1e3:.2f} ms an env-step); resets '
        f'{int(resets)}, physics_nan {int(nan_count)}; plane-box contact '
        f'active at the end of {int(box_steps)} of {GO1_STEPS} env-steps, and '
        f'on all four corners in {laid} of the {env.cfg.decimation} '
        f'substeps of env 1 laid on its back; launches per '
        f'env-step (K3, K2, K1, K3 per env): '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }; card {card}',
        flush=True)
  check(bool(ok), 'non-finite observation or reward on the Go1 path')
  check(int(nan_count) == 0, f'physics_nan fired {int(nan_count)} times')
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)},
        f'a Go1 env-step launched {shapes}, not 4/4/8 or 5/5/9')
  check(bool(term[1]) and per_step[-1] == (5, 5, 9, 0),
        'a Go1 env on its back did not reset with one more forward')
  check(laid > 0, 'the plane-box pair was not active for a trunk lying on '
        'the floor')
  act = acts[1]

  def three_steps():
    for _ in range(3):
      env.step(act)

  _, syncs = count_syncs(torch, three_steps)
  print(f'Go1: {len(syncs)} synchronizing calls in 3 env-steps', flush=True)
  check(len(syncs) == 3, 'env.step synchronizes other than once a step: '
        + '; '.join(sorted(set(syncs))))
  del env, obs, acts

  # ---- 8c: the demo trains at the registered envs, exports and plays ------
  with launches_per_step(kernels) as per_step:
    t0 = time.perf_counter()
    out = demo.main(['--log-root', root, '--train-iterations',
                     str(TRAIN_ITERS), '--steps', '50'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  runner = out['runner']
  check(runner is not None, 'the demo found a policy and did not train')
  cfg, env = runner.cfg, runner.env
  T = cfg.num_steps_per_env
  shapes = sorted(set(per_step))
  print(f'Go1 demo: trained {TRAIN_ITERS} iterations of {T} env-steps x '
        f'{env.num_envs} envs (widths actor {cfg.policy.actor_hidden_dims} '
        f'critic {cfg.policy.critic_hidden_dims}, '
        f'{cfg.algorithm.num_learning_epochs} epochs x '
        f'{cfg.algorithm.num_mini_batches} minibatches), exported and played '
        f'in {wall:.2f} s; launches per env-step (K3, K2, K1, K3 per env) '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }', flush=True)
  check(env.num_envs == 1024 and env.device.type == 'cuda',
        'the demo did not train 1024 envs on the card')
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)},
        f'a demo env-step launched {shapes}, not 4/4/8 or 5/5/9')
  run = os.path.join(root, cfg.experiment_name, 'demo')
  with open(os.path.join(run, 'metrics.jsonl')) as f:
    lines = [json.loads(line) for line in f]
  for l_ in lines:
    print(f'Go1 demo iteration {l_["iteration"]}: collection '
          f'{l_["collection_ms"]:.1f} ms, learning {l_["learning_ms"]:.1f} '
          f'ms, resets {l_["resets"]:.0f}, physics_nan '
          f'{l_["Episode_Termination/physics_nan"]:.0f}, loss '
          f'{l_["loss"]:.4f} kl {l_["kl"]:.5f}, mean reward '
          f'{l_["mean_reward"]:.4f}; card {card}', flush=True)
    check(all(math.isfinite(l_[k]) for k in ('loss', 'pg', 'v', 'ent', 'kl',
                                              'std')),
          f'non-finite loss logs at iteration {l_["iteration"]}')
    check(l_['Episode_Termination/physics_nan'] == 0,
          'physics_nan fired in the Go1 demo\'s training')
  last = lines[-1]
  print(f'Go1 demo: {TRAIN_ITERS * T * env.num_envs / last["wall_s"]:.1f} '
        f'training env-steps/s ({TRAIN_ITERS} x {T} x {env.num_envs} over '
        f'{last["wall_s"]:.3f} s of learn); card {card}', flush=True)
  ckpt = os.path.join(run, f'model_{TRAIN_ITERS}.pt')
  check(out['checkpoint'] == ckpt and os.path.exists(ckpt),
        f'the demo did not write and play {ckpt}')
  net0 = runner.alg.init_net(torch.Generator(device=env.device).manual_seed(
      cfg.seed + 1))
  for k, p in runner.ts.net.named_parameters():
    check(bool(torch.isfinite(p).all()), f'parameter {k} is not finite')
    check(not torch.equal(p, net0.get_parameter(k)),
          f'parameter {k} did not move')
  onnx_check(torch, runner, ckpt, 'Go1 demo')
  stats = out['play']
  print(f'Go1 demo play: {stats}', flush=True)
  check(math.isfinite(stats['mean_reward']), 'the demo\'s play gave a '
        'non-finite reward')
  torch.cuda.synchronize()
  launches = dict(LAUNCHES)
  print(f'Go1 path launches: {launches}', flush=True)
  check(launches.get('smooth_env', 0) == 0, 'the Go1 path launched K3\'s '
        'per-env form')
  del runner, env, out

  # ---- 8d: the card against the CPU ---------------------------------------
  e_obs, e_rew, same, flips, kept = go1_card_vs_cpu(torch)
  tol8 = 1e-3
  print(f'Go1, 8 envs, 5 env-steps, CUDA f32 vs CPU f64: obs err/(1+max|cpu|)'
        f' {e_obs:.3e}, reward {e_rew:.3e} (tolerance {tol8:g}), done flags '
        f'equal {same}; contact flips (env: env-step, |dist - margin| on the '
        f'CPU in m) { {e: (i, f"{g:.3e}") for e, (i, g) in flips.items()} } '
        f'(allowed within {FLIP_GAP:g} m of the threshold), {kept} envs '
        f'compared to the end', flush=True)
  check(e_obs <= tol8 and e_rew <= tol8 and same,
        'the Go1 env on the card disagrees with the CPU')
  check(all(g <= FLIP_GAP for _, g in flips.values()) and kept >= 6,
        'a contact flipped between the card and the CPU away from its '
        'threshold, or in more than two envs')
  return launches


TRACK_STEPS = 100  # env-steps of phase 9a
TRACK_PLAY_ENVS = 512  # envs of phase 9c's play of the Play cfg
TRACK_PLAY_STEPS = 250
# phase 9c's gate, written before the first call on the card: the shipped
# policy ends at most a tenth as many episodes by tracking terms as the
# zero-action agent, which ends at least one an env
TRACK_GATE_RATIO = 10


def tracking_card_vs_cpu(torch, num_envs: int = 8, steps: int = 5):
  """Phase 9d: the G1 tracking env on the shipped walk clip, its sampling
  ranges collapsed to a point (tracking_degenerate_ranges), on the card
  against the CPU (card_vs_cpu_flips)."""
  from mjlab_torch.asset_zoo.pretrained import G1_TRACKING_MOTION
  from mjlab_torch.tasks import registry
  return card_vs_cpu_flips(
      torch, TRACK_TASK,
      lambda: tracking_degenerate_ranges(registry.load_cfg(TRACK_TASK),
                                         num_envs, G1_TRACKING_MOTION),
      steps)


def motion_onnx_check(torch, runner, path: str, what: str,
                      normalized: bool = True) -> float:
  """The motion-baked ONNX the tracking runner wrote beside the checkpoint
  `path`, read back by parse_model and evaluated by run_motion_policy on
  256 of the run's own observations: the actions within 1e-6 of (1 + max
  |a|) of the runner's inference policy on the card, the normalizer folded
  in as the runner's running statistics (`normalized`; else the identity),
  and the motion outputs at time_step 0, 17, T - 1 and T + 5 the clip's
  rows (clipped to T - 1). Returns the actions' error over (1 + max
  |actions|)."""
  import os

  import numpy as np
  from mjlab_torch.rl import onnx_writer
  onnx = os.path.splitext(path)[0] + '.onnx'
  check(os.path.exists(onnx) and os.path.exists(onnx + '.meta.json'),
        f'{what}: {onnx} or its sidecar was not written')
  parsed = onnx_writer.parse_model(onnx)
  alg, ts = runner.alg, runner.ts
  obs = {k: v[:256] for k, v in ts.obs.items()}
  a_obs = alg._cat_obs(obs, alg.actor_groups).cpu().numpy()
  motion = runner.env.command_manager.terms['motion'].motion
  T = motion.time_step_total
  steps = np.tile([0, 17, T - 1, T + 5], 64)
  out = onnx_writer.run_motion_policy(parsed, a_obs, steps)
  want = runner.get_inference_policy()(obs).double().cpu()
  err = float((torch.as_tensor(out['actions']).double() - want).abs().max()
              ) / scale(want)
  rows = np.minimum(steps, T - 1)
  clip = {'joint_pos': motion.joint_pos[rows],
          'joint_vel': motion.joint_vel[rows],
          'anchor_pos_w': motion.body_pos_w[rows, 0],
          'anchor_quat_w': motion.body_quat_w[rows, 0]}
  frames = all(np.array_equal(out[k], v) for k, v in clip.items())
  init = parsed['initializers']
  norm = ts.actor_norm
  if normalized:
    folded = bool(
        np.array_equal(init['obs_mean'], norm.mean.cpu().numpy())
        and np.array_equal(init['obs_std'],
                           np.sqrt(norm.var.cpu().numpy()) + 1e-2))
  else:
    folded = bool((init['obs_mean'] == 0).all()
                  and (init['obs_std'] == 1).all())
  print(f'{what}: {os.path.basename(onnx)} outputs {parsed["outputs"]}, '
        f'graph in numpy vs the inference policy on the card, 256 '
        f'observations: err/(1+max|a|) {err:.3e} (tolerance 1e-6); the '
        f'clip\'s rows at time_step 0, 17, {T - 1}, {T + 5}: {frames}; the '
        f'{"running" if normalized else "identity"} normalizer folded in: '
        f'{folded}', flush=True)
  check(runner.cfg.policy.actor_obs_normalization == normalized,
        f'{what}: the task\'s normalization is not {normalized}')
  check(err <= 1e-6, f'{what}: the ONNX graph disagrees with the policy')
  check(frames, f'{what}: the ONNX graph\'s motion outputs are not the clip')
  check(folded, f'{what}: the ONNX graph does not fold in the '
        f'{"running" if normalized else "identity"} normalizer')
  return err


def tracking_path(torch, card: str, busy) -> 'tuple[dict, dict]':
  """Phase 9: the G1 motion-tracking task (BASELINE config 4). Returns the
  kernels' launches over its env-steps, training, demo and play, and K3's
  per-env form timed at the tracking task's segments."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_tracking_')
  try:
    return _tracking_path(torch, card, busy, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _tracking_path(torch, card: str, busy, root: str):
  import math
  import os

  from mjlab_torch.asset_zoo.pretrained import (
      G1_TRACKING_MOTION,
      G1_TRACKING_POLICY,
  )
  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.ops import smooth_kernel as k_smooth
  from mjlab_torch.ops.work import bound_ms, k3_work
  from mjlab_torch.physics import smooth_fused
  from mjlab_torch.physics.constraint import efc_layout
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.rl.runner import OnPolicyRunner
  from mjlab_torch.scripts import demo, play, train
  from mjlab_torch.tasks import registry

  kernels = ('smooth', 'newton', 'pd_solve', 'smooth_env')
  clip = str(G1_TRACKING_MOTION)
  torch.cuda.synchronize()
  reset_launches()

  # ---- 9a: the env at 4096 envs on the walk clip ---------------------------
  t0 = time.perf_counter()
  env = registry.make(TRACK_TASK, **{'scene.num_envs': B,
                                     'commands.motion.motion_file': clip})
  actor = load_actor(G1_TRACKING_POLICY)
  obs, _ = env.reset()
  torch.cuda.synchronize()
  s = env.model.stat
  lay = efc_layout(s)
  me = env.state.model
  plan = k_smooth.plan_of(me)
  motion = env.command_manager.terms['motion']
  print(f'tracking: built and reset {B} envs in {time.perf_counter() - t0:.2f}'
        f' s on {env.device}; nq {s.nq} nv {s.nv}, {s.pairs.ncon_max} contact '
        f'slots, caps {s.ncon_cap}/{s.ncon_cap1}, ncr {lay.ncr}, nefc '
        f'{lay.nefc}; per-env fields {env.per_env_fields}, K3 per-env '
        f'segments {plan.dims[15]:#07b}; obs {env.observation_dims}, actions '
        f'{env.action_dim}; clip {os.path.basename(clip)}, '
        f'{motion.motion.time_step_total} frames, {motion.n_bins} bins',
        flush=True)
  check(env.device.type == 'cuda', 'the tracking env is not on the card')
  check((s.nv, s.pairs.ncon_max, s.ncon_cap, s.ncon_cap1, lay.ncr, lay.nefc)
        == (35, 533, 32, 16, 144, 208), 'the tracking model does not have '
        'the G1 flat widths')
  check(env.per_env_fields == ['body_ipos', 'geom_friction', 'qpos0']
        and plan.dims[15] == 0b10001, 'the tracking env does not carry '
        'bconst and qpos0 per env')
  check(env.observation_dims == {'policy': 160, 'critic': 286}
        and env.action_dim == 29, 'the tracking env\'s widths are not 160, '
        '286 and 29')

  # K3 at tracking's per-env segments on the env's reset state, beside its
  # shared form on the same state (shared, per env, per env, shared); these
  # launches compare and time the kernel and are taken out of the path's
  # counts
  counted = dict(LAUNCHES)
  d = env.state.data
  kern = k_smooth.smooth_fused_cuda(me, d.qpos, d.qvel)
  plain = smooth_fused.plain_all(me, d)
  err3 = k3_max_err(kern, plain, s.nsite)
  rel3 = k3_rel_err(torch, kern, plain, s.nsite)
  check(rel3 <= 1e-4, f'K3 at tracking\'s segments disagrees with its plain '
        f'version: {rel3:.3e}')
  m_shared = env.scene.model
  k3_env = lambda: k_smooth.smooth_fused_cuda(me, d.qpos, d.qvel)
  k3_shared = lambda: k_smooth.smooth_fused_cuda(m_shared, d.qpos, d.qvel)
  dev_shared = [time_ms(torch, k3_shared, 20, busy=busy)]
  dev_env = [time_ms(torch, k3_env, 20, busy=busy),
             time_ms(torch, k3_env, 20, busy=busy)]
  dev_shared.append(time_ms(torch, k3_shared, 20, busy=busy))
  ms_env = time_ms(torch, k3_env, 20)
  plain_env = time_ms(torch, lambda: smooth_fused.plain_all(me, d), 5)
  b_env, by_env = bound_ms(*k3_work(me, d.qpos, d.qvel, kern))
  k3_tracking = dict(max_abs_err=err3, ms=ms_env,
                     device_ms=min(dev_env), plain_ms=plain_env,
                     bound_ms=b_env, bound_by=by_env, library_ms=None,
                     shared_device_ms=min(dev_shared))
  print(f'K3 per env at tracking\'s segments (bconst, qpos0): {ms_env:.4f} '
        f'ms, {dev_env[0]:.4f} and {dev_env[1]:.4f} ms behind a busy card '
        f'(shared form on the same state {dev_shared[0]:.4f} and '
        f'{dev_shared[1]:.4f} ms), bound {b_env:.5f} ms by {by_env} '
        f'(per-env table {4 * plan.etab.numel()} B); plain {plain_env:.4f} '
        f'ms; max abs err {err3:.3e}, err/(1+max|plain|) {rel3:.3e} '
        f'(tolerance 1e-4); card {card}', flush=True)
  del kern, plain
  LAUNCHES.clear()
  LAUNCHES.update(counted)

  # 100 env-steps under the shipped policy; env 1 tipped past anchor_ori
  # half-way, env 2's arm folded into its torso at the start
  view = env.scene['robot']
  qpos = fold_arm_qpos(env.state.data.qpos.clone(), view.idx.joint_names,
                       view.idx.q_adr, 2)
  env._state = env.state.replace(data=env.state.data.replace(qpos=qpos))
  ok = torch.ones((), dtype=torch.bool, device='cuda')
  nan_count = torch.zeros((), dtype=torch.long, device='cuda')
  resets = torch.zeros((), device='cuda')
  selfc = torch.zeros((), dtype=torch.long, device='cuda')
  looped = torch.zeros((), dtype=torch.long, device='cuda')
  per_step = []
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  for i in range(TRACK_STEPS):
    if i == TRACK_STEPS // 2:
      tip_over(torch, env, 1, TRACK_TIP)
    before = [LAUNCHES[k] for k in kernels]
    ts_before = env.state.command['motion']['time_steps']
    obs, rew, term, _, extras = env.step(actor(obs))
    per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
    ok &= torch.isfinite(obs['policy']).all() & torch.isfinite(rew).all()
    nan_count += extras['Episode_Termination/physics_nan']
    resets += extras['reset_count']
    selfc += (env.state.data.sensordata[:, 0] > 0).sum()
    looped += ((ts_before == motion.motion.time_step_total - 1) & ~term).sum()
    if i == TRACK_STEPS // 2:
      tipped = term[1]
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  shapes = sorted(set(per_step))
  st = env.state.command['motion']
  print(f'tracking: {TRACK_STEPS} env-steps x {B} envs under the shipped '
        f'policy in {wall:.3f} s = {TRACK_STEPS * B / wall:.1f} env-steps/s '
        f'({wall / TRACK_STEPS * 1e3:.2f} ms an env-step); resets '
        f'{int(resets)}, physics_nan {int(nan_count)}; env-steps of an env '
        f'with a self-collision count {int(selfc)}; clip ends looped '
        f'{int(looped)}; error_body_pos {float(st["metric/error_body_pos"].mean()):.4f} m; '
        f'sampling entropy {float(st["metric/sampling_entropy"][0]):.4f}; '
        f'launches per env-step (K3, K2, K1, K3 per env): '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }; card {card}',
        flush=True)
  check(bool(ok), 'non-finite observation or reward on the tracking path')
  check(int(nan_count) == 0, f'physics_nan fired {int(nan_count)} times')
  check(set(shapes) <= {(0, 4, 8, 4), (0, 5, 9, 5)},
        f'a tracking env-step launched {shapes}, not 0/4/8/4 or 0/5/9/5')
  check(bool(tipped), 'the tipped env did not end by a tracking term')
  check(int(selfc) > 0, 'the self-collision sensor counted nothing')
  check(int(looped) > 0, 'no env reached the clip\'s end')
  act = actor(obs)

  def three_steps():
    for _ in range(3):
      env.step(act)

  _, syncs = count_syncs(torch, three_steps)
  print(f'tracking: {len(syncs)} synchronizing calls in 3 env-steps',
        flush=True)
  check(len(syncs) <= 3, 'the tracking env-step synchronizes more than once '
        'a step: ' + '; '.join(sorted(set(syncs))))
  # one env-step stage by stage, as phase 5d times the velocity env's
  runs = []
  for _ in range(5):
    timer = StageTimer(torch)
    torch.cuda.synchronize()
    with timer('actor'):
      act = actor(obs)
    env._state, out = env.step_fn(env.state, act, stage=timer)
    obs = out[0]
    runs.append(timer)
  for name in runs[0].gpu:
    g = statistics.median(r.gpu.get(name, 0.0) for r in runs)
    h = statistics.median(r.host.get(name, 0.0) for r in runs)
    print(f'tracking env-step stage {name}: {g:.3f} ms between events, '
          f'{h:.3f} ms host issue (median of 5, {B} envs, {card})',
          flush=True)
  del env, obs, actor, me, d, m_shared, st

  # ---- 9b: three PPO iterations through train.main -------------------------
  argv = [TRACK_TASK, '--log-root', root, '--env.scene.num_envs', str(B),
          '--env.commands.motion.motion_file', clip]
  with launches_per_step(kernels) as per_step:
    t0 = time.perf_counter()
    runner = train.main(argv + ['--agent.max_iterations', str(TRAIN_ITERS),
                                '--run-name', 'a'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  cfg, env = runner.cfg, runner.env
  T = cfg.num_steps_per_env
  shapes = sorted(set(per_step))
  print(f'tracking train: {TRAIN_ITERS} iterations of {T} env-steps x '
        f'{env.num_envs} envs through train.main in {wall:.2f} s (env build '
        f'included); {type(runner).__name__}, widths actor '
        f'{cfg.policy.actor_hidden_dims} critic '
        f'{cfg.policy.critic_hidden_dims}, normalization actor '
        f'{cfg.policy.actor_obs_normalization} critic '
        f'{cfg.policy.critic_obs_normalization}; launches per env-step '
        f'(K3, K2, K1, K3 per env) { {s_: per_step.count(s_) for s_ in shapes} }',
        flush=True)
  check(type(runner).__name__ == 'MotionTrackingOnPolicyRunner'
        and env.num_envs == B and cfg.policy.actor_obs_normalization
        and cfg.policy.critic_obs_normalization,
        'train.main did not train 4096 tracking envs with the tracking '
        'runner and normalization on')
  check(set(shapes) <= {(0, 4, 8, 4), (0, 5, 9, 5)},
        f'a tracking rollout env-step launched {shapes}')
  run = os.path.join(root, cfg.experiment_name, 'a')
  with open(os.path.join(run, 'metrics.jsonl')) as f:
    lines = [json.loads(line) for line in f]
  for l_ in lines:
    print(f'tracking train iteration {l_["iteration"]}: collection '
          f'{l_["collection_ms"]:.1f} ms, learning {l_["learning_ms"]:.1f} '
          f'ms, resets {l_["resets"]:.0f}, physics_nan '
          f'{l_["Episode_Termination/physics_nan"]:.0f}, loss '
          f'{l_["loss"]:.4f} kl {l_["kl"]:.5f}, mean reward '
          f'{l_["mean_reward"]:.4f}, error_body_pos '
          f'{l_.get("Metrics/motion/error_body_pos", float("nan")):.4f}; '
          f'card {card}', flush=True)
    check(all(math.isfinite(l_[k]) for k in ('loss', 'pg', 'v', 'ent', 'kl',
                                              'std')),
          f'non-finite loss logs at iteration {l_["iteration"]}')
    check(l_['Episode_Termination/physics_nan'] == 0,
          'physics_nan fired in the tracking training')
  last = lines[-1]
  print(f'tracking train: {TRAIN_ITERS * T * B / last["wall_s"]:.1f} '
        f'training env-steps/s ({TRAIN_ITERS} x {T} x {B} over '
        f'{last["wall_s"]:.3f} s of learn); card {card}', flush=True)
  ckpt = os.path.join(run, f'model_{TRAIN_ITERS}.pt')
  check(os.path.exists(ckpt), f'{ckpt} was not written')
  norm = runner.ts.actor_norm
  check(float(norm.count) > 1.0, 'the actor normalizer was not updated')
  motion_onnx_check(torch, runner, ckpt, 'tracking train')
  fresh = OnPolicyRunner(env, cfg)
  fresh.load(ckpt)
  a, b = runner.ts, fresh.ts
  same = (a.iteration == b.iteration == TRAIN_ITERS
          and all(torch.equal(p, b.net.get_parameter(k))
                  for k, p in a.net.named_parameters())
          and all(torch.equal(x, y) for x, y in zip(
              a.actor_norm.buffers(), b.actor_norm.buffers()))
          and all(torch.equal(x, y) for x, y in zip(
              a.critic_norm.buffers(), b.critic_norm.buffers())))
  check(same, 'the tracking checkpoint did not load bit for bit')
  del fresh, runner, env, a, b
  resumed = train.main(argv + ['--agent.max_iterations', '1', '--run-name',
                               'b', '--resume'])
  ckpt4 = os.path.join(root, cfg.experiment_name, 'b',
                       f'model_{TRAIN_ITERS + 1}.onnx')
  print(f'tracking train: the checkpoint loads bit for bit (normalizers '
        f'included); resumed from iteration {TRAIN_ITERS}, wrote '
        f'{os.path.basename(ckpt4)}: {os.path.exists(ckpt4)}', flush=True)
  check(resumed.ts.iteration == TRAIN_ITERS + 1 and os.path.exists(ckpt4),
        'the resumed tracking run did not write its checkpoint and ONNX')
  del resumed

  # ---- 9c: the shipped policy on its clip, and against the zero agent -------
  empty = os.path.join(root, 'no_runs')
  out = demo.main(['--task', TRACK_TASK, '--log-root', empty, '--steps',
                   '50'])
  stats = out['play']
  print(f'tracking demo: played {out["checkpoint"]} on '
        f'{stats["motion_file"]}: {stats}', flush=True)
  check(out['runner'] is None and out['checkpoint'] == str(
      G1_TRACKING_POLICY), 'the demo did not play the shipped policy')
  check(stats['motion_file'] == clip, 'the demo played the shipped policy '
        'on another clip than its own')
  ended = {}
  for agent in ('trained', 'zero'):
    t0 = time.perf_counter()
    stats = play.main([TRACK_TASK + '-Play', '--agent', agent, '--log-root',
                       empty, '--num-envs', str(TRACK_PLAY_ENVS), '--steps',
                       str(TRACK_PLAY_STEPS),
                       '--env.commands.motion.motion_file', clip])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    causes = stats['terminations']
    ended[agent] = stats['resets'] - causes['time_out']
    print(f'tracking play ({agent} agent, {TRACK_PLAY_ENVS} envs x '
          f'{TRACK_PLAY_STEPS} env-steps, Play cfg, walk clip) in {wall:.2f} '
          f's: episodes ended by tracking terms {ended[agent]} (anchor_pos '
          f'{causes["anchor_pos"]}, anchor_ori {causes["anchor_ori"]}, '
          f'ee_body_pos {causes["ee_body_pos"]}), time_out '
          f'{causes["time_out"]}, physics_nan {causes["physics_nan"]}; '
          f'error_body_pos {stats["metrics"]["motion/error_body_pos"]:.4f} m, '
          f'error_anchor_rot {stats["metrics"]["motion/error_anchor_rot"]:.4f}'
          f' rad, mean reward {stats["mean_reward"]:.4f}; card {card}',
          flush=True)
    check(causes['physics_nan'] == 0, f'physics_nan fired in the {agent} '
          'agent\'s play')
  check(ended['zero'] >= TRACK_PLAY_ENVS
        and ended['trained'] * TRACK_GATE_RATIO <= ended['zero'],
        f'the shipped policy ended {ended["trained"]} episodes by tracking '
        f'terms, the zero agent {ended["zero"]}: not a tenth or fewer')
  torch.cuda.synchronize()
  launches = dict(LAUNCHES)
  print(f'tracking path launches: {launches}', flush=True)
  check(launches.get('smooth', 0) == 0, 'the tracking path launched K3\'s '
        'shared-table form')

  # ---- 9d: the card against the CPU ---------------------------------------
  e_obs, e_rew, same, flips, kept = tracking_card_vs_cpu(torch)
  tol9 = 1e-3
  print(f'tracking, 8 envs, 5 env-steps, CUDA f32 vs CPU f64: obs '
        f'err/(1+max|cpu|) {e_obs:.3e}, reward {e_rew:.3e} (tolerance '
        f'{tol9:g}), done flags equal {same}; contact flips (env: env-step, '
        f'|dist - margin| on the CPU in m) '
        f'{ {e: (i, f"{g:.3e}") for e, (i, g) in flips.items()} } (allowed '
        f'within {FLIP_GAP:g} m of the threshold), {kept} envs compared to '
        f'the end', flush=True)
  check(e_obs <= tol9 and e_rew <= tol9 and same,
        'the tracking env on the card disagrees with the CPU')
  check(all(g <= FLIP_GAP for _, g in flips.values()) and kept >= 6,
        'a contact flipped between the card and the CPU away from its '
        'threshold, or in more than two envs')
  return launches, k3_tracking


ROUGH_TASK = 'Mjlab-Velocity-Rough-Unitree-G1'
ROUGH_GO1_TASK = 'Mjlab-Velocity-Rough-Unitree-Go1'
ROUGH_STEPS = 150  # env-steps of phase 10b
ROUGH_GO1_STEPS = 100  # env-steps of phase 10d
ROUGH_PLAY_STEPS = 50  # env-steps of each Play cfg's scripts.play
# phase 10b's collision gate, written before the first call on the card:
# over the run, no active heightfield contact of the G1 is deeper than this
# (m). Soft contacts hold a standing or fallen robot within a few mm to cm
# of the surface; a robot sinking through the terrain reads tens of cm.
ROUGH_PEN_GATE = 0.05


def hfield_groups(s) -> dict:
  """{'SPHERE' | 'CAPSULE' | 'BOX': (first slot, slots)} of the heightfield
  pair groups of a model's static pair table."""
  from mjlab_torch.physics.types import GeomType
  return {GeomType(k[1]).name: (v[3], len(v[0]) * v[4])
          for k, v in s.pairs.groups.items()
          if k[0] == int(GeomType.HFIELD)}


@contextlib.contextmanager
def hfield_recorder(torch, groups: dict, ncon: int, device):
  """Within the block, every physics substep (pipeline.step) adds, per
  heightfield pair group, the envs with an active slot of it, and the
  active heightfield contacts whose world normal points down (z < 0: they
  push their geom into the terrain); and lowers the deepest active
  heightfield contact's dist, where it was (env * ncon + slot), its
  normal's z and its env's downward contacts in that substep, and the
  deepest downward contact's dist. All stay on the card. Yields {'hits':
  {group: count}, 'down': (), 'deepest': (), 'at': (), 'nz_at': (),
  'down_at': (), 'down_deepest': ()}."""
  from mjlab_torch.physics import pipeline
  hf = torch.zeros(ncon, dtype=torch.bool, device=device)
  for first, n in groups.values():
    hf[first:first + n] = True
  zero = lambda dtype: torch.zeros((), dtype=dtype, device=device)
  rec = {'hits': {k: zero(torch.long) for k in groups},
         'down': zero(torch.long),
         'deepest': torch.full((), 1e9, device=device),
         'at': zero(torch.long), 'nz_at': zero(torch.float32),
         'down_at': zero(torch.long),
         'down_deepest': torch.full((), 1e9, device=device)}
  plain_step = pipeline.step

  def recording_step(m, d):
    out = plain_step(m, d)
    c = out.contact
    active = c.dist < c.includemargin
    for k, (first, n) in groups.items():
      rec['hits'][k] += active[:, first:first + n].any(-1).sum()
    nz = c.frame[..., 0, 2]
    down = active & hf & (nz < 0)
    rec['down'] += down.sum()
    far = torch.full_like(c.dist, 1e9)
    rec['down_deepest'] = torch.minimum(
        rec['down_deepest'], torch.where(down, c.dist, far).min())
    low, at = torch.where(active & hf, c.dist, far).flatten().min(0)
    deeper = low < rec['deepest']
    rec['deepest'] = torch.where(deeper, low, rec['deepest'])
    rec['at'] = torch.where(deeper, at, rec['at'])
    # index_select: indexing by a tensor of no dims would read it on the host
    pick = lambda x, i: x.index_select(0, i.view(1))[0]
    rec['nz_at'] = torch.where(deeper, pick(nz.flatten(), at).float(),
                               rec['nz_at'])
    rec['down_at'] = torch.where(deeper, pick(down.sum(-1), at // ncon),
                                 rec['down_at'])
    return out

  pipeline.step = recording_step
  try:
    yield rec
  finally:
    pipeline.step = plain_step


def lay_on_back(torch, env, env_id: int, height: float, quat) -> None:
  """Put env `env_id`'s root at its spawn origin + `height`, turned to
  `quat` (w, x, y, z), at rest (tip_over_state)."""
  org = env.state.curriculum['terrain_levels']['origins'][env_id]
  pos = org + torch.tensor([0.0, 0.0, height], device=org.device)
  env._state = tip_over_state(torch, env.state, env_id, quat=quat, pos=pos)


def rough_widths(torch, env, what: str) -> dict:
  """Phase 10a/10d: the rough env's heightfield and its widths (slots, caps,
  contact rows ncr, nefc) as constraint.make_efc builds them on its state,
  and whether K2 takes them."""
  from mjlab_torch.ops import newton as k_newton
  from mjlab_torch.physics import constraint, pipeline, smooth
  m, s = env.scene.model, env.model.stat
  d = pipeline.fwd_velocity(m, pipeline.fwd_position(m, env.state.data))
  efc = constraint.make_efc(m, smooth.fwd_smooth(m, smooth.actuation(m, d)))
  ncr, nl = efc['c_J'].shape[1], efc['l_sign'].shape[1]
  out = dict(nrow=s.hfield_nrow, ncol=s.hfield_ncol,
             hfield_bytes=m.hfield_data.numel() * m.hfield_data.element_size(),
             slots=s.pairs.ncon_max, caps=(s.ncon_cap, s.ncon_cap1), ncr=ncr,
             nl=nl, nefc=constraint.efc_layout(s).nefc,
             fits=k_newton.fits(s.nv, ncr, nl),
             smem=k_newton.newton_smem_bytes(s.nv, ncr, nl),
             groups=hfield_groups(s))
  print(f'{what}: heightfield {out["nrow"]} x {out["ncol"]} samples, '
        f'{out["hfield_bytes"]} B on {m.hfield_data.device}; '
        f'{out["slots"]} contact slots, caps {out["caps"][0]} frictional + '
        f'{out["caps"][1]} frictionless, ncr {ncr}, nl {nl}, nefc '
        f'{out["nefc"]}; hfield groups (first slot, slots) {out["groups"]}; '
        f'K2 fits: {out["fits"]} ({out["smem"]} B of shared memory a block)',
        flush=True)
  check(env.device.type == 'cuda', f'{what}: the env is not on the card')
  check(out['fits'], f'{what}: K2 does not take n {s.nv}, ncr {ncr}, nl {nl}')
  return out


def substep_stages(torch, m, d, card: str, what: str) -> dict:
  """The physics substep of pipeline.step stage by stage on the state `d`:
  per stage, the median over 5 of the ms between CUDA events around it and
  of its host issue time (as phase 3b). Returns {stage: (gpu, host)}."""
  from mjlab_torch.physics import collision, constraint, pipeline, sensor
  from mjlab_torch.physics import smooth, smooth_fused, solver
  efc = {}

  def run_efc(d):
    efc['v'] = constraint.make_efc(m, d)
    return d

  plain = (constraint.elliptic_dmax(m.stat)
           or constraint.efc_layout(m.stat).ne)
  solve = 'solve (plain Newton, K1)' if plain else 'solve (K2)'
  if m.stat.integrator == 0:  # Euler, its implicit damping solved by K1
    integrate = ('euler (K1)', lambda d: pipeline._euler(m, d))
  else:
    integrate = ('implicitfast (K1)', lambda d: pipeline._implicitfast(m, d))
  stages = (
      ('smooth_all (K3)', lambda d: smooth_fused.smooth_all(m, d)),
      ('collision', lambda d: smooth.transmission(
          m, smooth.tendon(m, collision.collision(m, d)))),
      ('passive+actuation', lambda d: smooth.actuation(
          m, pipeline.fwd_velocity(m, d))),
      ('fwd_smooth (K1)', lambda d: smooth.fwd_smooth(m, d)),
      ('make_efc', run_efc),
      (solve, lambda d: solver.solve(m, d, efc['v'])),
      ('sensors', lambda d: sensor.sensors(
          m, d.replace(qacc_warmstart=d.qacc))),
      integrate,
  )
  gpu = {name: [] for name, _ in stages}
  host = {name: [] for name, _ in stages}
  for _ in range(5):
    torch.cuda.synchronize()
    for name, fn in stages:
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      t0 = time.perf_counter()
      start.record()
      d = fn(d)
      end.record()
      host[name].append((time.perf_counter() - t0) * 1e3)
      end.synchronize()
      gpu[name].append(start.elapsed_time(end))
  out = {name: (statistics.median(gpu[name]), statistics.median(host[name]))
         for name, _ in stages}
  total = sum(g for g, _ in out.values())
  for name, (g, h) in out.items():
    print(f'{what} substep stage {name}: {g:.3f} ms between events '
          f'({g / total:.3f} of the substep), {h:.3f} ms host issue (median '
          f'of 5, {d.qpos.shape[0]} envs, {card})', flush=True)
  return out


def rough_path(torch, card: str, busy) -> 'tuple[dict, dict]':
  """Phase 10: the rough-terrain velocity tasks (heightfield terrain, the
  terrain-level curriculum). Returns the kernels' launches over the path's
  own runs (the envs' builds, resets and steps, training and play of both
  robots), and K2's numbers at the Go1 rough shape."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_rough_')
  try:
    return _rough_path(torch, card, busy, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def training_checks(torch, runner, run: str, what: str, card: str,
                    iters: int = TRAIN_ITERS, terrain: bool = True,
                    onnx=onnx_check) -> float:
  """The checks of a training run `run` (its runner and log directory):
  finite losses, no physics_nan, with `terrain` the terrain-level metric
  logged, the parameters moved, the ONNX beside the last checkpoint read
  back against the inference policy by `onnx`. Returns the run's training
  env-steps/s."""
  import math
  import os
  cfg, env = runner.cfg, runner.env
  T = cfg.num_steps_per_env
  with open(os.path.join(run, 'metrics.jsonl')) as f:
    lines = [json.loads(line) for line in f]
  for l_ in lines:
    print(f'{what} iteration {l_["iteration"]}: collection '
          f'{l_["collection_ms"]:.1f} ms, learning {l_["learning_ms"]:.1f} ms,'
          f' resets {l_["resets"]:.0f}, physics_nan '
          f'{l_["Episode_Termination/physics_nan"]:.0f}, '
          + ''.join(f'{k.split("/")[-1]} {l_[k]:.0f}, ' for k in l_
                    if k.startswith('Episode_Termination/')
                    and not k.endswith('physics_nan'))
          + (f'terrain level '
             f'{l_.get("Curriculum/terrain_levels", float("nan")):.4f}, '
             if terrain else '')
          + f'loss {l_["loss"]:.4f} kl {l_["kl"]:.5f}, mean reward '
          f'{l_["mean_reward"]:.4f}; card {card}', flush=True)
    check(all(math.isfinite(l_[k]) for k in ('loss', 'pg', 'v', 'ent', 'kl',
                                              'std')),
          f'{what}: non-finite loss logs at iteration {l_["iteration"]}')
    check(l_['Episode_Termination/physics_nan'] == 0,
          f'{what}: physics_nan fired')
    check(not terrain or math.isfinite(
        l_.get('Curriculum/terrain_levels', math.nan)),
          f'{what}: Curriculum/terrain_levels was not logged')
  last = lines[-1]
  rate = iters * T * env.num_envs / last['wall_s']
  print(f'{what}: {rate:.1f} training env-steps/s ({iters} x {T} x '
        f'{env.num_envs} over {last["wall_s"]:.3f} s of learn); card {card}',
        flush=True)
  ckpt = os.path.join(run, f'model_{iters}.pt')
  check(os.path.exists(ckpt), f'{ckpt} was not written')
  net0 = runner.alg.init_net(torch.Generator(device=env.device).manual_seed(
      cfg.seed + 1))
  for k, p in runner.ts.net.named_parameters():
    check(bool(torch.isfinite(p).all()), f'parameter {k} is not finite')
    check(not torch.equal(p, net0.get_parameter(k)),
          f'parameter {k} did not move')
  onnx(torch, runner, ckpt, what)
  return rate


def rough_play(torch, task: str, ckpt: str, root: str, card: str,
               kernels, path) -> dict:
  """`scripts.play` of the rough Play cfg `task` with the checkpoint `ckpt`
  at B envs on the card for ROUGH_PLAY_STEPS env-steps, its launches added
  to `path`: finite statistics, no physics_nan, 4/4/8 (5/5/9) launches an
  env-step."""
  import math

  from mjlab_torch.scripts import play
  with counted(path), launches_per_step(kernels) as per_step:
    t0 = time.perf_counter()
    stats = play.main([task, '--checkpoint', ckpt, '--num-envs', str(B),
                       '--steps', str(ROUGH_PLAY_STEPS), '--log-root', root])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  shapes = sorted(set(per_step))
  print(f'{task}: scripts.play of {ckpt.rsplit("/", 2)[-2]}/'
        f'{ckpt.rsplit("/", 1)[-1]}, {ROUGH_PLAY_STEPS} env-steps x envs '
        f'{sorted(per_step.envs)} in {wall:.2f} s (env build included); mean '
        f'reward {stats["mean_reward"]:.4f}, resets {stats["resets"]} by '
        f'cause {stats["terminations"]}; launches per env-step (K3, K2, K1, '
        f'K3 per env) { {s_: per_step.count(s_) for s_ in shapes} }; card '
        f'{card}', flush=True)
  check(per_step.envs == {(B, 'cuda')} and len(per_step) == ROUGH_PLAY_STEPS,
        f'{task} did not play {B} envs on the card')
  check(math.isfinite(stats['mean_reward'])
        and stats['terminations'].get('physics_nan', 0) == 0,
        f'{task}: non-finite reward or physics_nan in play')
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)},
        f'a {task} env-step launched {shapes}, not 4/4/8 or 5/5/9')
  return stats


def _rough_path(torch, card: str, busy, root: str):
  import collections
  import os

  from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
  from mjlab_torch.ops import LAUNCHES
  from mjlab_torch.ops import newton as k_newton
  from mjlab_torch.ops.work import bound_ms, newton_work
  from mjlab_torch.physics import constraint, pipeline, smooth, solver
  from mjlab_torch.physics import smooth_fused
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.scripts import demo, train
  from mjlab_torch.tasks import registry

  kernels = ('smooth', 'newton', 'pd_solve', 'smooth_env')
  # the launches of the path's own runs (env build, reset and steps,
  # training, play); rough_widths, substep_stages and K2 against its plain
  # version run outside them
  path = collections.Counter()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()

  # ---- 10a: build the G1 rough env; its heightfield and widths -------------
  t0 = time.perf_counter()
  with counted(path):
    env = registry.make(ROUGH_TASK, **{'scene.num_envs': B})  # cuda, f32
    obs, _ = env.reset()
  torch.cuda.synchronize()
  print(f'G1 rough: built and reset {B} envs in '
        f'{time.perf_counter() - t0:.2f} s; obs {env.observation_dims}, '
        f'actions {env.action_dim}', flush=True)
  w = rough_widths(torch, env, 'G1 rough')
  check((w['slots'], w['caps'], w['ncr'], w['nefc']) == (568, (32, 16), 144,
                                                         208)
        and set(w['groups']) == {'SPHERE', 'CAPSULE'},
        'the G1 rough model is not 568 slots, caps 32 + 16, ncr 144, nefc '
        '208 with the hfield-sphere and -capsule pairs')
  check(smooth_fused.enabled(env.model.stat), 'K3 refuses the G1 rough scene')
  terrain = env.scene.terrain
  max_level = terrain.max_level

  # ---- 10b: 150 env-steps under the shipped G1 flat actor ------------------
  actor = load_actor(G1_FLAT_POLICY)
  width = actor.norm.mean.shape[-1]
  check(width == env.observation_dims['policy'],
        f'the shipped actor takes {width} observations, the rough env gives '
        f'{env.observation_dims["policy"]}')
  dev = env.device
  ok = torch.ones((), dtype=torch.bool, device=dev)
  nan_count = torch.zeros((), dtype=torch.long, device=dev)
  resets = torch.zeros((), device=dev)
  moved = torch.zeros((), dtype=torch.long, device=dev)
  lvl_lo = torch.full((), max_level, dtype=torch.long, device=dev)
  lvl_hi = torch.zeros((), dtype=torch.long, device=dev)
  falls = torch.zeros(max_level, device=dev)
  exposure = torch.zeros(max_level, device=dev)
  per_step = []
  ncon = env.state.data.contact.dist.shape[1]
  # the env on the highest level is tipped over at env-step 10: at least
  # one reset demotes an env
  tipped = int(env.state.curriculum['terrain_levels']['levels'].argmax())
  with counted(path), hfield_recorder(torch, w['groups'], ncon, dev) as rec:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ROUGH_STEPS):
      if i == 10:
        tip_over(torch, env, tipped)
      before = [LAUNCHES[k] for k in kernels]
      levels0 = env.state.curriculum['terrain_levels']['levels'].long()
      obs, rew, term, trunc, extras = env.step(actor(obs))
      per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels,
                                                             before)))
      ok &= torch.isfinite(obs['policy']).all() & torch.isfinite(rew).all()
      nan_count += extras['Episode_Termination/physics_nan']
      resets += extras['reset_count']
      levels = env.state.curriculum['terrain_levels']['levels'].long()
      moved += ((levels != levels0) & (term | trunc)).sum()
      lvl_lo = torch.minimum(lvl_lo, levels.min())
      lvl_hi = torch.maximum(lvl_hi, levels.max())
      falls.index_add_(0, levels0, term.float())
      exposure.index_add_(0, levels0, torch.ones_like(rew))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the gate's, before env 3 is laid
    gate = {k: rec[k].clone() for k in ('deepest', 'at', 'nz_at', 'down_at',
                                        'down', 'down_deepest')}
    # env 3 laid on its back on its spawn platform, the pelvis sphere 2 mm
    # (the torso capsule 16 mm) into the surface: its substeps take the
    # hfield-sphere rows
    lay_on_back(torch, env, 3, 0.068, (0.7071068, 0.0, -0.7071068, 0.0))
    before = [LAUNCHES[k] for k in kernels]
    obs, *_ = env.step(actor(obs))
    per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
  shapes = sorted(set(per_step))
  deep = float(gate['deepest'])
  st = env.model.stat
  e_at, slot_at = divmod(int(gate['at']), ncon)
  level_at = int(env.state.curriculum['terrain_levels']['levels'][e_at])
  print(f'G1 rough: the deepest active hfield contact was env {e_at}\'s '
        f'{st.geom_names[st.con_geom2[slot_at]]} (slot {slot_at}), its '
        f'world normal\'s z {float(gate["nz_at"]):.5f}, with '
        f'{int(gate["down_at"])} active hfield contacts of that env '
        f'pointing down in that substep; that env is now on level '
        f'{level_at}, type {int(terrain.terrain_types[e_at])}. Active hfield '
        f'contacts with a downward world normal over the '
        f'{env.cfg.decimation * ROUGH_STEPS} substeps, summed over envs: '
        f'{int(gate["down"])}, the deepest of them '
        f'{float(gate["down_deepest"]):.5f} m', flush=True)
  print(f'G1 rough: {ROUGH_STEPS} env-steps x {B} envs under the shipped '
        f'flat actor in {wall:.3f} s = {ROUGH_STEPS * B / wall:.1f} '
        f'env-steps/s ({wall / ROUGH_STEPS * 1e3:.2f} ms an env-step, the '
        f'contact recorder on); resets {int(resets)}, physics_nan '
        f'{int(nan_count)}; launches per env-step (K3, K2, K1, K3 per env) '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }; substeps with an '
        f'active hfield contact of each pair, summed over envs (env 3 laid '
        f'on its back for the last env-step) '
        f'{ {k: int(v) for k, v in rec["hits"].items()} }; deepest active '
        f'hfield contact over the {env.cfg.decimation * ROUGH_STEPS} '
        f'substeps of the '
        f'{ROUGH_STEPS} env-steps {deep:.5f} m (gate: above '
        f'-{ROUGH_PEN_GATE:g} m); curriculum: {int(moved)} '
        f'resets moved a level, levels seen {int(lvl_lo)}..{int(lvl_hi)} of '
        f'0..{max_level - 1}; card {card}', flush=True)
  fell = (falls / exposure.clamp_min(1)).tolist()
  print('G1 rough, the shipped flat actor: episodes ended by fell_over per '
        'env-step at each terrain level '
        + ', '.join(f'{lv}: {f:.5f} ({int(n)} env-steps)' for lv, (f, n)
                    in enumerate(zip(fell, exposure.tolist())) if n)
        + f'; card {card}', flush=True)
  check(bool(ok), 'non-finite observation or reward on the G1 rough path')
  check(int(nan_count) == 0, f'physics_nan fired {int(nan_count)} times')
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)}
        and (5, 5, 9, 0) in shapes,
        f'a G1 rough env-step launched {shapes}, not 4/4/8 or 5/5/9')
  check(all(int(v) > 0 for v in rec['hits'].values()),
        'an hfield pair group was never active on the G1 rough path')
  check(deep > -ROUGH_PEN_GATE, f'an active hfield contact reached {deep:.4f}'
        f' m, deeper than the gate\'s {ROUGH_PEN_GATE:g} m')
  check(int(moved) > 0 and int(lvl_lo) >= 0 and int(lvl_hi) < max_level,
        'the curriculum moved no level on a reset, or a level left its range')
  act = actor(obs)

  def three_steps():
    for _ in range(3):
      env.step(act)

  with counted(path):
    _, syncs = count_syncs(torch, three_steps)
  print(f'G1 rough: {len(syncs)} synchronizing calls in 3 env-steps',
        flush=True)
  check(len(syncs) == 3, 'env.step synchronizes other than once a step: '
        + '; '.join(sorted(set(syncs))))
  runs = []
  with counted(path):
    for _ in range(5):
      timer = StageTimer(torch)
      torch.cuda.synchronize()
      with timer('actor'):
        act = actor(obs)
      env._state, out = env.step_fn(env.state, act, stage=timer)
      obs = out[0]
      runs.append(timer)
  for name in runs[0].gpu:
    g = statistics.median(r.gpu.get(name, 0.0) for r in runs)
    h = statistics.median(r.host.get(name, 0.0) for r in runs)
    print(f'G1 rough env-step stage {name}: {g:.3f} ms between events, '
          f'{h:.3f} ms host issue (median of 5, {B} envs, {card})',
          flush=True)
  substep_stages(torch, env.state.model, env.state.data, card, 'G1 rough')
  peak = torch.cuda.max_memory_allocated()
  print(f'G1 rough: peak device memory {peak / 2**30:.2f} GiB '
        f'(torch.cuda.max_memory_allocated since phase 10 began); card '
        f'{card}', flush=True)
  del env, obs, act

  # ---- 10c: 3 PPO iterations through train.main; play of the Play cfg ------
  argv = [ROUGH_TASK, '--log-root', root, '--env.scene.num_envs', str(B),
          '--agent.max_iterations', str(TRAIN_ITERS), '--run-name', 'a']
  with counted(path), launches_per_step(kernels) as per_step:
    t0 = time.perf_counter()
    runner = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  cfg, env = runner.cfg, runner.env
  shapes = sorted(set(per_step))
  print(f'G1 rough train: {TRAIN_ITERS} iterations of '
        f'{cfg.num_steps_per_env} env-steps x {env.num_envs} envs through '
        f'train.main in {wall:.2f} s (env build included); widths actor '
        f'{cfg.policy.actor_hidden_dims} critic '
        f'{cfg.policy.critic_hidden_dims}; launches per rollout env-step '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }', flush=True)
  check(per_step.envs == {(B, 'cuda')},
        'the rough training env is not 4096 envs on the card')
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)},
        f'a rough rollout env-step launched {shapes}')
  run = os.path.join(root, cfg.experiment_name, 'a')
  training_checks(torch, runner, run, 'G1 rough train', card)
  del runner, env
  rough_play(torch, ROUGH_TASK + '-Play',
             os.path.join(run, f'model_{TRAIN_ITERS}.pt'), root, card,
             kernels, path)

  # ---- 10d: the Go1 rough env under random actions --------------------------
  with counted(path):
    env = registry.make(ROUGH_GO1_TASK, **{'scene.num_envs': B})
    obs, _ = env.reset()
  wg = rough_widths(torch, env, 'Go1 rough')
  check((wg['slots'], wg['caps'], wg['ncr'], wg['nefc']) == (91, (64, 0),
                                                             256, 286)
        and set(wg['groups']) == {'SPHERE', 'CAPSULE', 'BOX'},
        'the Go1 rough model is not 91 slots, 64 kept, ncr 256, nefc 286 '
        'with the three hfield pairs')
  # env 1 laid on its back, the trunk box 2 mm into the surface; env 2's
  # trunk lowered 4 cm, so its calves touch: the first env-step takes the
  # hfield-box and hfield-capsule rows
  lay_on_back(torch, env, 1, 0.048, (0.0, 1.0, 0.0, 0.0))
  key = torch.as_tensor(env.scene.mj_model.key_qpos[0][:7],
                        dtype=torch.float32)
  lay_on_back(torch, env, 2, float(key[2]) - 0.04, key[3:7].tolist())
  agen = torch.Generator(device='cuda').manual_seed(10)
  acts = torch.randn(ROUGH_GO1_STEPS, B, env.action_dim, generator=agen,
                     device='cuda')
  ok = torch.ones((), dtype=torch.bool, device='cuda')
  nan_count = torch.zeros((), dtype=torch.long, device='cuda')
  per_step = []
  ncon = env.state.data.contact.dist.shape[1]
  with counted(path), hfield_recorder(torch, wg['groups'], ncon,
                                      env.device) as rec:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ROUGH_GO1_STEPS):
      before = [LAUNCHES[k] for k in kernels]
      obs, rew, _, _, extras = env.step(acts[i])
      per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels,
                                                             before)))
      ok &= torch.isfinite(obs['policy']).all() & torch.isfinite(rew).all()
      nan_count += extras['Episode_Termination/physics_nan']
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  shapes = sorted(set(per_step))
  print(f'Go1 rough: {ROUGH_GO1_STEPS} env-steps x {B} envs under random '
        f'actions in {wall:.3f} s = {ROUGH_GO1_STEPS * B / wall:.1f} '
        f'env-steps/s (the contact recorder on); physics_nan '
        f'{int(nan_count)}; launches per env-step (K3, K2, K1, K3 per env) '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }; substeps with an '
        f'active hfield contact of each pair, summed over envs '
        f'{ {k: int(v) for k, v in rec["hits"].items()} }; deepest active '
        f'hfield contact {float(rec["deepest"]):.5f} m (its world normal\'s '
        f'z {float(rec["nz_at"]):.5f}, {int(rec["down_at"])} downward '
        f'contacts in its env); active hfield contacts with a downward '
        f'world normal {int(rec["down"])}, the deepest '
        f'{float(rec["down_deepest"]):.5f} m; card {card}', flush=True)
  check(bool(ok), 'non-finite observation or reward on the Go1 rough path')
  check(int(nan_count) == 0, f'physics_nan fired {int(nan_count)} times')
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)},
        f'a Go1 rough env-step launched {shapes}, not 4/4/8 or 5/5/9')
  check(all(int(v) > 0 for v in rec['hits'].values()),
        'an hfield pair group was never active on the Go1 rough path')

  # K2 at the Go1 rough shape against newton_plain, on the state the Go1s
  # reached on the terrain, and timed
  m = env.state.model
  df = pipeline.fwd_velocity(m, pipeline.fwd_position(m, env.state.data))
  df = smooth.fwd_smooth(m, smooth.actuation(m, df))
  efc = constraint.make_efc(m, df)
  s = env.model.stat
  n, ncr, nl = s.nv, efc['c_J'].shape[1], efc['l_sign'].shape[1]
  check((n, ncr, nl) == (18, 256, 12), 'the Go1 rough rows are not 18/256/12')
  args = solver.newton_args(df, efc)
  iters, polish, ldof, grad_th = solver.solver_params(s)
  kargs = dict(iterations=iters, ls_polish=polish, ldof=ldof,
               grad_th=grad_th)
  got = k_newton.newton_solve_cuda(*args, **kargs)
  want = solver.newton_plain(*args, iters, polish, ldof, grad_th)
  rel = max(rel_err(a, b) for a, b in zip(got, want))
  call = lambda: k_newton.newton_solve_cuda(*args, **kargs)
  need, nc, rows_b, nbytes, flops = newton_work(args, iters,
                                                polish, ldof, grad_th)
  bound, by = bound_ms(nbytes, flops)
  k2 = dict(max_abs_err=max_err(got[0], want[0]), rel_err=rel,
            ms=time_ms(torch, call, 20),
            device_ms=time_ms(torch, call, 20, busy=busy),
            plain_ms=time_ms(torch, lambda: solver.newton_plain(
                *args, iters, polish, ldof, grad_th), 5),
            bound_ms=bound, bound_by=by, library_ms=None,
            newton_steps=float(need.double().mean()),
            active_contact_rows=float(nc.double().mean()), ncr=ncr,
            smem_bytes=k_newton.newton_smem_bytes(n, ncr, nl))
  print(f'Go1 rough K2 (n {n}, ncr {ncr}, nl {nl}): max abs err '
        f'{k2["max_abs_err"]:.3e}, worst output err/(1+max|plain|) {rel:.3e} '
        f'(tolerance 1e-3); {k2["ms"]:.4f} ms, {k2["device_ms"]:.4f} ms behind '
        f'a busy card, plain {k2["plain_ms"]:.4f} ms, bound {bound:.5f} ms by '
        f'{by} (dev / bound {k2["device_ms"] / bound:.1f}x); Newton steps an '
        f'env {k2["newton_steps"]:.2f}, active contact rows an env '
        f'{k2["active_contact_rows"]:.2f} of {ncr}; {k2["smem_bytes"]} B of '
        f'shared memory a block; card {card}', flush=True)
  check(rel <= 1e-3, f'K2 disagrees with its plain version at the Go1 rough '
        f'shape: {rel:.3e}')
  substep_stages(torch, m, env.state.data, card, 'Go1 rough')
  del env, obs, acts, args, efc, df, m

  # the demo finds no Go1 rough policy: it trains at B envs through
  # train.main, exports and plays; then the Play cfg plays its checkpoint
  with counted(path), launches_per_step(kernels) as per_step:
    t0 = time.perf_counter()
    out = demo.main(['--task', ROUGH_GO1_TASK, '--log-root', root,
                     '--num-envs', str(B), '--train-iterations',
                     str(TRAIN_ITERS), '--steps', str(ROUGH_PLAY_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  runner = out['runner']
  check(runner is not None, 'the Go1 rough demo found a policy and did not '
        'train')
  shapes = sorted(set(per_step))
  print(f'Go1 rough demo: trained {TRAIN_ITERS} iterations at '
        f'{runner.env.num_envs} envs, exported and played in {wall:.2f} s; '
        f'envs that stepped {sorted(per_step.envs)}; launches per env-step '
        f'(K3, K2, K1, K3 per env) { {s_: per_step.count(s_) for s_ in shapes} }'
        f'; card {card}', flush=True)
  check((B, 'cuda') in per_step.envs and runner.env.num_envs == B,
        f'the Go1 rough demo did not train {B} envs on the card')
  check(set(shapes) <= {(4, 4, 8, 0), (5, 5, 9, 0)},
        f'a Go1 rough demo env-step launched {shapes}')
  run = os.path.join(root, runner.cfg.experiment_name, 'demo')
  training_checks(torch, runner, run, 'Go1 rough demo', card)
  ckpt = out['checkpoint']
  del runner, out
  rough_play(torch, ROUGH_GO1_TASK + '-Play', ckpt, root, card, kernels,
             path)
  launches = dict(path)
  print(f'rough path launches (10a-10d: env builds and resets, env-steps, '
        f'training, play): {launches}', flush=True)
  check(launches.get('smooth_env', 0) == 0, 'the rough path launched K3\'s '
        'per-env form')

  # ---- 10e: the card against the CPU ---------------------------------------
  for task in (ROUGH_TASK, ROUGH_GO1_TASK):
    e_obs, e_rew, same, flips, kept = task_card_vs_cpu(torch, task)
    print(f'{task}, 8 envs, 5 env-steps, CUDA f32 vs CPU f64: obs '
          f'err/(1+max|cpu|) {e_obs:.3e}, reward {e_rew:.3e} (tolerance '
          f'1e-3), done flags equal {same}; contact flips (env: env-step, '
          f'|dist - margin| on the CPU in m) '
          f'{ {e: (i, f"{g:.3e}") for e, (i, g) in flips.items()} } (allowed '
          f'within {FLIP_GAP:g} m of the threshold), {kept} envs compared to '
          f'the end', flush=True)
    check(e_obs <= 1e-3 and e_rew <= 1e-3 and same,
          f'{task} on the card disagrees with the CPU')
    check(all(g <= FLIP_GAP for _, g in flips.values()) and kept >= 6,
          'a contact flipped between the card and the CPU away from its '
          'threshold, or in more than two envs')
  return launches, k2


NAN_ENV = 1234  # the env phase 11a spins up
NAN_STEP = 12  # ... before this env-step of the first iteration (1-based)
NAN_SPIN = 1e5  # rad/s about every axis of its base: blows up in one step
NAN_COST_STEPS = 20  # env-steps of each timing run of phase 11d


@contextlib.contextmanager
def spun_up(torch, store: dict):
  """Within the block, before the NAN_STEP-th env-step of any env, env
  NAN_ENV's base angular velocity is set to NAN_SPIN about every axis;
  `store` gets that step's starting state and processed action."""
  from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnv
  plain_step = ManagerBasedRlEnv._step_fn
  calls = [0]

  def step(self, state, action, *a, **kw):
    calls[0] += 1
    if calls[0] == NAN_STEP:
      qvel = state.data.qvel.clone()
      qvel[NAN_ENV, 3:6] = NAN_SPIN
      state = state.replace(data=state.data.replace(qvel=qvel))
      act = torch.as_tensor(action, dtype=state.actions.dtype,
                            device=self.device)
      store.update(state=state, processed=self.action_manager.process(act))
    return plain_step(self, state, action, *a, **kw)

  ManagerBasedRlEnv._step_fn = step
  try:
    yield
  finally:
    ManagerBasedRlEnv._step_fn = plain_step


def same_bits(a, b) -> bool:
  """Equal bit for bit (NaN included): two tensors or arrays."""
  import numpy as np
  a = a.detach().cpu().numpy() if hasattr(a, 'detach') else np.asarray(a)
  b = b.detach().cpu().numpy() if hasattr(b, 'detach') else np.asarray(b)
  return a.dtype == b.dtype and a.shape == b.shape and \
      a.tobytes() == b.tobytes()


def same_payload(torch, a, b) -> bool:
  """Two checkpoint payloads (or numpy trees) equal key for key and bit for
  bit."""
  import numpy as np
  if isinstance(a, dict):
    return (isinstance(b, dict) and list(a) == list(b)
            and all(same_payload(torch, a[k], b[k]) for k in a))
  if torch.is_tensor(a) or isinstance(a, np.ndarray):
    return type(a) is type(b) and same_bits(a, b)
  return type(a) is type(b) and a == b


def nan_path(torch, card: str) -> dict:
  """Phase 11: the NaN guard, the blowup ring and the tools that read them,
  on G1 flat training at 4096 envs. Returns the kernels' launches over the
  path's own runs (training, a guarded rollout, the replay)."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_nan_')
  try:
    return _nan_path(torch, card, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _nan_path(torch, card: str, root: str) -> dict:
  import collections
  import glob
  import math
  import os

  import numpy as np

  from mjlab_torch.scripts import blowup_replay, nan_viz, train
  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.nan_guard import NanGuard

  path = collections.Counter()
  ring_dir = os.path.join(root, 'ring')

  # ---- 11a: train.main with the guard and the ring; one env spun up --------
  argv = [ENV_TASK, '--log-root', root, '--env.scene.num_envs', str(B),
          '--agent.max_iterations', str(TRAIN_ITERS), '--run-name', 'g',
          '--enable-nan-guard']
  seen = {}
  os.environ['MJLAB_BLOWUP_DUMP'] = ring_dir
  try:
    with spun_up(torch, seen), \
        launches_per_step(('smooth', 'newton', 'pd_solve')) as per_step, \
        counted(path):
      t0 = time.perf_counter()
      runner = train.main(argv)
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
  finally:
    del os.environ['MJLAB_BLOWUP_DUMP']
  cfg, env = runner.cfg, runner.env
  T = cfg.num_steps_per_env
  run = os.path.join(root, cfg.experiment_name, 'g')
  print(f'nan path: {TRAIN_ITERS} iterations of {T} env-steps x {B} envs '
        f'through train.main --enable-nan-guard with MJLAB_BLOWUP_DUMP in '
        f'{wall:.2f} s; env {NAN_ENV} spun to {NAN_SPIN:g} rad/s before '
        f'env-step {NAN_STEP}; card {card}', flush=True)
  check(env.device.type == 'cuda' and env.num_envs == B and 'state' in seen,
        'the nan path did not run 4096 envs on the card or spin an env up')
  shapes = sorted(set(per_step))
  print(f'nan path launches per rollout env-step (K3, K2, K1), guard and '
        f'ring on: { {s_: per_step.count(s_) for s_ in shapes} }', flush=True)
  check(len(per_step) == TRAIN_ITERS * T
        and set(shapes) <= {(4, 4, 8), (5, 5, 9)},
        f'{len(per_step)} env-steps launched {shapes}, not 4/4/8 or 5/5/9')

  dumps = sorted(glob.glob(os.path.join(run, 'nan_dumps', 'nan_dump_*.npz')))
  check(len(dumps) == 1, f'the guard wrote {len(dumps)} dumps, not 1')
  with np.load(dumps[0]) as z:
    dump = {k: z[k] for k in z.files}
  print(f'nan path: the guard dumped envs {dump["bad_env_ids"].tolist()} at '
        f'step {dump["steps"].tolist()}; qvel non-finite in '
        f'{int((~np.isfinite(dump["qvel"])).any(-1).sum())} of '
        f'{dump["qvel"].shape[1]} dumped envs; model.npz written: '
        f'{os.path.exists(os.path.join(run, "nan_dumps", "model.npz"))}',
        flush=True)
  check(NAN_ENV in dump['bad_env_ids'].tolist()
        and dump['steps'].tolist() == [NAN_STEP],
        'the guard did not dump the spun-up env at its step')

  with np.load(os.path.join(ring_dir, 'blowup_ring.npz')) as z:
    ring = {k: z[k] for k in z.files}
  ids = ring['env_ids'].tolist()
  check(NAN_ENV in ids, f'the ring holds envs {ids}, not {NAN_ENV}')
  row = ids.index(NAN_ENV)
  st = seen['state']
  bits = {k: same_bits(ring[k][row], getattr(st.data, k)[NAN_ENV])
          for k in ('qpos', 'qvel', 'ctrl', 'qacc_warmstart', 'xfrc_applied',
                    'qfrc_applied', 'time')}
  bits['processed_action'] = same_bits(ring['processed_action'][row],
                                       seen['processed'][NAN_ENV])
  bits['episode_length'] = same_bits(ring['episode_length'][row],
                                     st.episode_length[NAN_ENV])
  for f in env.per_env_fields:
    bits[f'model_{f}'] = same_bits(ring[f'model_{f}'][row],
                                   getattr(st.model, f)[NAN_ENV])
  peaks = ring['qvel_peaks'][:, row]
  print(f'nan path: the ring holds {len(ids)} capture(s) (envs {ids}, '
        f'{int(ring["n_bad_total"])} bad envs in all); env {NAN_ENV}\'s '
        f'pre-substep state bit for bit: {bits}; its qvel peaks by substep '
        f'{peaks.tolist()}', flush=True)
  check(all(bits.values()), 'the ring does not hold the pre-substep state '
        'bit for bit')

  with open(os.path.join(run, 'metrics.jsonl')) as f:
    lines = [json.loads(line) for line in f]
  for l_ in lines:
    print(f'nan path iteration {l_["iteration"]}: physics_nan '
          f'{l_["Episode_Termination/physics_nan"]:.0f}, fell_over '
          f'{l_["Episode_Termination/fell_over"]:.0f}, loss {l_["loss"]:.4f} '
          f'kl {l_["kl"]:.5f}, collection {l_["collection_ms"]:.1f} ms, '
          f'learning {l_["learning_ms"]:.1f} ms; card {card}', flush=True)
    check(all(math.isfinite(l_[k]) for k in ('loss', 'pg', 'v', 'ent', 'kl',
                                              'std')),
          f'non-finite loss logs at iteration {l_["iteration"]}')
  check(lines[0]['Episode_Termination/physics_nan'] >= 1,
        'physics_nan did not count the spun-up env')

  # the checkpoint: the ring-on run's, and the same state saved with the
  # ring taken off, key for key and bit for bit
  ckpt = os.path.join(run, f'model_{TRAIN_ITERS}.pt')
  on_state = runner.ts.env_state
  check(bool(on_state.forensic), 'the ring is not in the state')
  runner.ts.env_state = on_state.replace(forensic={})
  off = os.path.join(root, 'ring_off.pt')
  runner.save(off)
  runner.ts.env_state = on_state
  a = torch.load(ckpt, weights_only=True)
  b = torch.load(off, weights_only=True)
  same = same_payload(torch, a, b)
  print(f'nan path: {os.path.basename(ckpt)} (ring on) equals the same '
        f'state saved with the ring off, key for key and bit for bit: '
        f'{same}; env_state keys {sorted(a["env_state"])}', flush=True)
  check(same and 'forensic' not in a['env_state'],
        'the checkpoint carries the ring or differs from a ring-off one')
  del a, b

  # one guarded rollout on a fresh guard: the waits and the launches
  alg, ts = runner.alg, runner.ts
  with launches_per_step(('smooth', 'newton', 'pd_solve')) as per_step2, \
      counted(path):
    alg._step_fn = NanGuard(env, out_dir=os.path.join(root, 'g2')).wrap(
        env.step_fn)
    _, syncs = count_syncs(torch, lambda: alg._rollout(ts))
  shapes2 = sorted(set(per_step2))
  print(f'nan path: {len(syncs)} synchronizing calls in a guarded rollout '
        f'of {T} env-steps with the ring on; launches per env-step '
        f'{ {s_: per_step2.count(s_) for s_ in shapes2} }', flush=True)
  check(len(syncs) == T, 'the guarded rollout synchronizes other than once '
        'an env-step: ' + '; '.join(sorted(set(syncs))))
  check(len(per_step2) == T and set(shapes2) <= {(4, 4, 8), (5, 5, 9)},
        f'the guarded env-steps launched {shapes2}')
  del runner, alg, ts, env

  # ---- 11b: the replay of the ring on the card -----------------------------
  with counted(path):
    t0 = time.perf_counter()
    batch, results = blowup_replay.main([ring_dir, '--task', ENV_TASK,
                                         '--num-envs', str(B)])
    torch.cuda.synchronize()
  by = {r['variant']: r for r in results}
  print(f'nan path replay: {time.perf_counter() - t0:.1f} s; captured peaks '
        f'{batch["qvel_peaks"].T.tolist()}; peaks_err env-f32 '
        f'{by["env-f32"]["peaks_err"]:.3e}, eng-f32 '
        f'{by["eng-f32"]["peaks_err"]:.3e} (tolerance 1e-05), eng-f64 (the '
        f'CPU, {by["eng-f64"]["envs"]} envs) {by["eng-f64"]["peaks_err"]:.3e},'
        f' eng-it3x {by["eng-it3x"]["peaks_err"]:.3e}, eng-nocap '
        f'{by["eng-nocap"]["peaks_err"]:.3e}; launches by variant '
        f'{ {k: r["launches"] for k, r in by.items()} }; card {card}',
        flush=True)
  check(by['eng-f32']['peaks_err'] <= 1e-5 and
        by['env-f32']['peaks_err'] <= 1e-5,
        'the replay on the card does not repeat the captured qvel peaks')
  check(by['eng-f64']['envs'] == len(batch['env_ids'])
        and not by['eng-f64']['launches'], 'eng-f64 did not run on the CPU')
  check(all(by[v]['launches'].get(k, 0) > 0 for v in ('env-f32', 'eng-f32')
            for k in ('smooth', 'newton', 'pd_solve')),
        'the float32 replay did not run K1-K3 on the card')

  # ---- 11c: nan_viz on the dump -------------------------------------------
  try:
    nan_viz.main([dumps[0]])
  except SystemExit as e:
    fail(f'nan_viz exited {e.code}')

  # ---- 11d: what the guard and the ring cost an env-step -------------------
  def env_of(ring_on: bool):
    if ring_on:
      os.environ['MJLAB_BLOWUP_DUMP'] = os.path.join(root, 'ring_cost')
    try:
      env = registry.make(ENV_TASK, **{'scene.num_envs': B})
    finally:
      os.environ.pop('MJLAB_BLOWUP_DUMP', None)
    step = env.step_fn
    if ring_on:
      step = NanGuard(env, out_dir=os.path.join(root, 'g3')).wrap(step)
    state, _ = env.init_state()
    return env, step, [state]

  runs = {'off': env_of(False), 'on': env_of(True)}
  env0 = runs['off'][0]
  zero = torch.zeros(B, env0.action_dim, device=env0.device)

  def timed(what):
    _, step, box = runs[what]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NAN_COST_STEPS):
      box[0], _ = step(box[0], zero)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / NAN_COST_STEPS

  for what in runs:
    timed(what)  # warm up
  order = ('off', 'on', 'on', 'off')
  ms = [timed(w) for w in order]
  print(f'nan path cost, G1 flat env-step at {B} envs under zero actions, '
        f'{NAN_COST_STEPS} env-steps each, in turns (ms an env-step): '
        + ', '.join(f'{w} {m:.3f}' for w, m in zip(order, ms))
        + f'; card {card}', flush=True)
  del runs
  return path


TINY_TASKS = ('Mjlab-Velocity-Flat-Tiny', 'Mjlab-Velocity-Rough-Tiny',
              'Mjlab-Tracking-Flat-Tiny')
TINY_MODULES = ('mjlab_torch.tasks.velocity.config.tiny,'
                'mjlab_torch.tasks.tracking.config.tiny')
TINY_STEPS = 100  # env-steps of each Tiny task in phase 12b
TINY_ITERS = 2  # PPO iterations of each Tiny task in phase 12b
# env-steps of phase 12c: 60, not the 150 of phase 5, so that phase 12 stays
# near 150 s (an elliptic env-step takes about 590 ms on an H100)
ELL_STEPS = 60
# phase 12c's K1 launches an env-step, without and with a reset: each of
# the 4 substeps runs K1 in fwd_smooth, in each of the plain Newton's 10
# iterations and in implicitfast; a reset's forward adds fwd_smooth and a
# Newton solve
ELL_K1 = (4 * (1 + 10 + 1), 4 * (1 + 10 + 1) + 1 + 10)


def tiny_floor_states(key_qpos, nv: int, batch: int, seed: int):
  """`batch` TinyBot states on the plane as numpy (qpos, qvel) from numpy's
  default_rng(seed), with joint noise and a random yaw, in turns: upside
  down with the base box's top face flat 2 mm deep in the plane (its
  colliding feet in the air, its arm's visual capsules through the floor),
  and standing with the feet 2 mm deep. Velocities std 0.3."""
  import numpy as np
  rng = np.random.default_rng(seed)
  qpos = np.tile(np.asarray(key_qpos, np.float64), (batch, 1))
  qpos[:, 7:] += 0.3 * rng.normal(size=(batch, qpos.shape[1] - 7))
  half_yaw = rng.uniform(-np.pi, np.pi, batch) / 2
  c, s, z = np.cos(half_yaw), np.sin(half_yaw), np.zeros(batch)
  up = np.arange(batch) % 3 == 0
  # the yaw, then half a turn about x for the envs upside down
  qpos[:, 3:7] = np.where(up[:, None], np.stack([z, c, s, z], -1),
                          np.stack([c, z, z, s], -1))
  qpos[:, 2] = np.where(up, 0.028, 0.068)
  return qpos, 0.3 * rng.normal(size=(batch, nv))


def tiny_kernels(torch, card: str, busy) -> dict:
  """Phase 12a: K1-K3 at the TinyBot's shapes (n = 8, its free base and
  2-link arm, 8 uncompacted contact slots, 32 pyramid rows, 2 limits) on
  4096 TinyBot floor states, each against its plain version and timed as
  in phase 2. Returns {kernel: its numbers}."""
  import numpy as np

  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import tiny_flat_arrays

  arrays = tiny_flat_arrays()
  m = phys.put_model(arrays)
  qpos, qvel = tiny_floor_states(arrays.key_qpos[0], m.stat.nv, B, seed=12)
  f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device='cuda')
  d = phys.make_batched_data(m, B).replace(
      qpos=f32(qpos), qvel=f32(qvel),
      ctrl=f32(np.tile(arrays.key_ctrl[0], (B, 1))))
  return shape_kernels(torch, card, busy, 'TinyBot', m, d, (8, 32, 2))


def elliptic_cfg(cfg):
  """A G1 flat velocity cfg with the elliptic friction cone."""
  cfg.sim.mujoco.cone = 'elliptic'
  return cfg


def elliptic_hessians(torch, card: str, busy) -> dict:
  """Phase 12a: K1 on the Hessians of every Newton iteration of the
  elliptic G1 (M, the friction and limit diagonal, the frictionless rows
  and the elliptic cone's DM x DM blocks J^T B J of 32 compacted frictional
  slots) at 4096 G1 flat envs dropped 3 cm onto the floor, each against
  its plain version; timed on the last. Returns K1's numbers there."""
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import g1_flat_arrays
  from mjlab_torch.ops import pd_solve as k_pd
  from mjlab_torch.physics import constraint, linalg, pipeline, smooth
  from mjlab_torch.physics import solver
  from mjlab_torch.tasks import registry

  mjcfg = elliptic_cfg(registry.load_cfg(ENV_TASK)).sim.mujoco
  arrays = mjcfg.apply(g1_flat_arrays())
  m = phys.put_model(arrays)
  s = m.stat
  check(s.cone == 1 and constraint.elliptic_dmax(s) == 3,
        'the elliptic G1 model has no elliptic rows of condim 3')
  d = g1_states(torch, phys, arrays, m, B, 0.03,
                torch.Generator().manual_seed(12))
  df = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  df = smooth.fwd_smooth(m, smooth.actuation(m, df))
  efc = constraint.make_efc(m, df)
  args, xargs = solver.newton_args(df, efc), solver.elliptic_args(efc)
  seen, x = newton_hessians(torch, m, args, xargs=xargs)
  xJ, x_aref, xD, x_mu, x_fr, x_act = xargs
  jx = torch.einsum('bcdv,bv->bcd', xJ, x) - x_aref
  mid, bot, *_ = solver._elliptic_zones(jx, xD, x_mu, x_fr, x_act)
  zones = dict(active=int(x_act.sum()), middle=int(mid.sum()),
               bottom=int(bot.sum()))
  # per iteration: K1 against its plain version, and each of them against
  # the plain version in float64 on the same float32 inputs, whose distance
  # is the float32 floor of these ill-conditioned systems
  errs = []
  for H, g in seen:
    x_k, x_p = k_pd.solve_pd_cuda(H, g), linalg.solve_pd(H, g)
    x_64 = linalg.solve_pd(H.double(), g.double())
    errs.append((rel_err(x_k, x_p), rel_err(x_k, x_64), rel_err(x_p, x_64)))
  ev = torch.linalg.eigvalsh(seen[0][0].double())
  cond = (ev[:, -1] / ev[:, 0]).median()
  print(f'elliptic G1 K1 input: {len(seen)} Newton iterations of {B} envs, '
        f'n {s.nv}, the x block {tuple(xJ.shape[1:3])} (slots, rows) and '
        f'{efc["c_J"].shape[1]} frictionless rows; elliptic slots at the '
        f'solution {zones}; median condition number of the first Hessian '
        f'{float(cond):.3e}. By iteration, err/(1+max|ref|) of K1 against '
        f'its plain version, of K1 against the float64 solve, of the plain '
        f'version against the float64 solve: '
        + ', '.join(f'({a:.2e}, {b:.2e}, {c:.2e})' for a, b, c in errs)
        + ' (tolerance: 1e-4 beyond twice the plain version\'s float32 '
        'floor, and never above 1e-3)', flush=True)
  check(zones['middle'] > 0, 'no elliptic contact in the cone\'s middle '
        'zone: the Hessians hold no non-diagonal block')
  # the floor follows the plain version; the fixed ceiling keeps a worse
  # plain solve from widening K1's gate without bound
  check(all(a <= min(1e-4 + 2 * c, 1e-3) and b <= min(1e-4 + 2 * c, 1e-3)
            for a, b, c in errs),
        'K1 disagrees with its plain version on the elliptic Hessians '
        'beyond their float32 floor or the 1e-3 ceiling')
  out = k1_numbers(torch, busy, *seen[-1], 'the elliptic G1 Hessians')
  out['rel_err_by_iteration'] = errs
  out['median_condition_number'] = float(cond)
  out['zones'] = zones
  print(f'elliptic G1 pd_solve: max abs err {out["max_abs_err"]:.3e}; '
        f'{out["ms"]:.4f} ms, {out["device_ms"]:.4f} ms behind a busy card, '
        f'plain {out["plain_ms"]:.4f} ms, bound {out["bound_ms"]:.5f} ms by '
        f'{out["bound_by"]}, library {out["library_ms"]:.4f} ms; card {card}',
        flush=True)
  return out


def tiny_path(torch, card: str) -> dict:
  """Phase 12b: the three Tiny tasks at 4096 envs. Returns the kernels'
  launches over their builds, resets, env-steps and training."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_tiny_')
  try:
    return _tiny_path(torch, card, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _tiny_path(torch, card: str, root: str) -> dict:
  import collections
  import os

  from mjlab_torch.ops import LAUNCHES
  from mjlab_torch.physics import smooth_fused
  from mjlab_torch.scripts import train
  from mjlab_torch.tasks import registry

  kernels = ('smooth', 'newton', 'pd_solve', 'smooth_env')
  path = collections.Counter()
  # the Tiny tasks register through the registry's module hook
  os.environ['MJLAB_TASKS_MODULES'] = TINY_MODULES
  check(set(TINY_TASKS) <= set(registry.registered_tasks()),
        'MJLAB_TASKS_MODULES did not register the Tiny tasks')
  from mjlab_torch.tasks.tracking.config.tiny import write_tiny_motion
  clip = write_tiny_motion(os.path.join(root, 'tiny_wave.npz'))
  rates = {}
  for task in TINY_TASKS:
    tracking = task.startswith('Mjlab-Tracking')
    rough = 'Rough' in task
    allowed = ({(0, 4, 8, 4), (0, 5, 9, 5)} if tracking
               else {(4, 4, 8, 0), (5, 5, 9, 0)})
    cfg = registry.load_cfg(task)
    if tracking:
      cfg.commands.motion.motion_file = clip
    t0 = time.perf_counter()
    with counted(path):
      env = registry.make(task, cfg=cfg, **{'scene.num_envs': B})
      obs, _ = env.reset()
    torch.cuda.synchronize()
    s = env.model.stat
    hf = hfield_groups(s)
    print(f'{task}: built and reset {B} envs in '
          f'{time.perf_counter() - t0:.2f} s on {env.device}; nq {s.nq} nv '
          f'{s.nv} nu {s.nu}, {s.pairs.ncon_max} contact slots, caps '
          f'{s.ncon_cap}/{s.ncon_cap1}, hfield groups {hf}, per-env fields '
          f'{env.per_env_fields}; obs {env.observation_dims}, actions '
          f'{env.action_dim}', flush=True)
    check(env.device.type == 'cuda', f'{task}: the env is not on the card')
    check(smooth_fused.enabled(s), f'{task}: K3 refuses the TinyBot tree')
    check(rough == bool(hf), f'{task}: heightfield pairs {hf}')
    hf_mask = torch.zeros(s.pairs.ncon_max, dtype=torch.bool,
                          device='cuda')
    for first, n in hf.values():
      hf_mask[first:first + n] = True
    dev = env.device
    agen = torch.Generator(device='cuda').manual_seed(12)
    acts = torch.randn(TINY_STEPS, B, env.action_dim, generator=agen,
                       device='cuda')
    ok = torch.ones((), dtype=torch.bool, device=dev)
    nan_count = torch.zeros((), dtype=torch.long, device=dev)
    resets = torch.zeros((), device=dev)
    hf_hits = torch.zeros((), dtype=torch.long, device=dev)
    moved = torch.zeros((), dtype=torch.long, device=dev)
    lvl_lo = torch.full((), 10 ** 6, dtype=torch.long, device=dev)
    lvl_hi = torch.zeros((), dtype=torch.long, device=dev)
    levels_of = lambda: env.state.curriculum['terrain_levels'][
        'levels'].long()
    tipped = int(levels_of().argmax()) if rough else B - 1
    per_step = []
    with counted(path):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      for i in range(TINY_STEPS):
        if i == 10:  # a reset on the path (on rough, a demotion)
          tip_over(torch, env, tipped)
        before = [LAUNCHES[k] for k in kernels]
        levels0 = levels_of() if rough else None
        obs, rew, term, trunc, extras = env.step(acts[i])
        per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels,
                                                               before)))
        ok &= torch.isfinite(rew).all() & torch.isfinite(obs['policy']).all()
        nan_count += extras['Episode_Termination/physics_nan']
        resets += extras['reset_count']
        if rough:
          c = env.state.data.contact
          hf_hits += ((c.dist < c.includemargin) & hf_mask).any(-1).sum()
          levels = levels_of()
          moved += ((levels != levels0) & (term | trunc)).sum()
          lvl_lo = torch.minimum(lvl_lo, levels.min())
          lvl_hi = torch.maximum(lvl_hi, levels.max())
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
    shapes = sorted(set(per_step))
    rates[task] = TINY_STEPS * B / wall
    max_level = env.scene.terrain.max_level if rough else 0
    print(f'{task}: {TINY_STEPS} env-steps x {B} envs under random actions '
          f'in {wall:.3f} s = {rates[task]:.1f} env-steps/s '
          f'({wall / TINY_STEPS * 1e3:.2f} ms an env-step); resets '
          f'{int(resets)}, physics_nan {int(nan_count)}; launches per '
          f'env-step (K3, K2, K1, K3 per env) '
          f'{ {s_: per_step.count(s_) for s_ in shapes} }'
          + (f'; env-substep ends with an active hfield contact '
             f'{int(hf_hits)}, resets that moved a level {int(moved)}, '
             f'levels seen {int(lvl_lo)}..{int(lvl_hi)} of '
             f'0..{max_level - 1}' if rough else '')
          + f'; card {card}', flush=True)
    check(bool(ok), f'{task}: non-finite observation or reward')
    check(int(nan_count) == 0, f'{task}: physics_nan fired '
          f'{int(nan_count)} times')
    check(set(shapes) <= allowed and len(shapes) == 2,
          f'{task}: an env-step launched {shapes}, not {sorted(allowed)}')
    check(not rough or (int(hf_hits) > 0 and int(moved) > 0
                        and int(lvl_lo) >= 0 and int(lvl_hi) < max_level),
          f'{task}: no active heightfield contact, or the curriculum moved '
          'no level on a reset, or a level left its range')
    act = acts[0]

    def three_steps():
      for _ in range(3):
        env.step(act)

    with counted(path):
      _, syncs = count_syncs(torch, three_steps)
    check(len(syncs) == 3, f'{task}: env.step synchronizes other than once '
          'a step: ' + '; '.join(sorted(set(syncs))))
    del env, obs, acts

    argv = [task, '--log-root', root, '--env.scene.num_envs', str(B),
            '--agent.max_iterations', str(TINY_ITERS), '--run-name', task]
    if tracking:
      argv += ['--env.commands.motion.motion_file', clip]
    with counted(path), launches_per_step(kernels) as per_step:
      t0 = time.perf_counter()
      runner = train.main(argv)
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
    shapes = sorted(set(per_step))
    print(f'{task} train: {TINY_ITERS} iterations of '
          f'{runner.cfg.num_steps_per_env} env-steps x {runner.env.num_envs} '
          f'envs through train.main in {wall:.2f} s (env build included), '
          f'{type(runner).__name__}; launches per rollout env-step '
          f'{ {s_: per_step.count(s_) for s_ in shapes} }', flush=True)
    check(per_step.envs == {(B, 'cuda')} and set(shapes) <= allowed,
          f'{task}: the training env-steps launched {shapes} on '
          f'{per_step.envs}')
    onnx = ((lambda *a: motion_onnx_check(*a, normalized=False))
            if tracking else onnx_check)
    rates[task + ' train'] = training_checks(
        torch, runner, os.path.join(root, runner.cfg.experiment_name, task),
        f'{task} train', card, iters=TINY_ITERS, terrain=False, onnx=onnx)
    del runner

  e_obs, e_rew, same, flips, kept = task_card_vs_cpu(torch, TINY_TASKS[0])
  print(f'{TINY_TASKS[0]}, 8 envs, 5 env-steps, CUDA f32 vs CPU f64: obs '
        f'err/(1+max|cpu|) {e_obs:.3e}, reward {e_rew:.3e} (tolerance 1e-3),'
        f' done flags equal {same}; contact flips {flips}, {kept} envs '
        f'compared to the end', flush=True)
  check(e_obs <= 1e-3 and e_rew <= 1e-3 and same,
        f'{TINY_TASKS[0]} on the card disagrees with the CPU')
  check(all(g <= FLIP_GAP for _, g in flips.values()) and kept >= 6,
        'a contact flipped between the card and the CPU away from its '
        'threshold, or in more than two envs')
  print(f'Tiny path rates (env-steps/s; card {card}): '
        + ', '.join(f'{k} {v:.1f}' for k, v in rates.items()), flush=True)
  return dict(path)


def elliptic_path(torch, card: str) -> dict:
  """Phase 12c: G1 flat velocity with cone='elliptic' at 4096 envs.
  Returns the kernels' launches over its build, reset, env-steps and
  training."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_elliptic_')
  try:
    return _elliptic_path(torch, card, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _elliptic_path(torch, card: str, root: str) -> dict:
  import collections
  import os

  from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
  from mjlab_torch.ops import LAUNCHES
  from mjlab_torch.physics import constraint
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.scripts import train
  from mjlab_torch.tasks import registry
  from mjlab_torch.tasks.velocity import mdp

  kernels = ('smooth', 'newton', 'pd_solve', 'smooth_env')
  allowed = {(4, 0, ELL_K1[0], 0), (5, 0, ELL_K1[1], 0)}
  path = collections.Counter()
  t0 = time.perf_counter()
  with counted(path):
    env = registry.make(ENV_TASK, cfg=elliptic_cfg(registry.load_cfg(
        ENV_TASK)), **{'scene.num_envs': B})
    obs, _ = env.reset()
  torch.cuda.synchronize()
  s = env.model.stat
  lay = constraint.efc_layout(s)
  print(f'G1 elliptic: built and reset {B} envs in '
        f'{time.perf_counter() - t0:.2f} s on {env.device}; cone {s.cone}, '
        f'{s.pairs.ncon_max} slots, caps {s.ncon_cap}/{s.ncon_cap1}, elliptic'
        f' rows a slot {constraint.elliptic_dmax(s)}, nefc {lay.nefc}, '
        f'per-env fields {env.per_env_fields}', flush=True)
  check(env.device.type == 'cuda' and s.cone == 1
        and constraint.elliptic_dmax(s) == 3,
        'the elliptic G1 env is not on the card with elliptic rows')
  actor = load_actor(G1_FLAT_POLICY)
  dev = env.device
  ok = torch.ones((), dtype=torch.bool, device=dev)
  nan_count = torch.zeros((), dtype=torch.long, device=dev)
  fell = torch.zeros((), device=dev)
  resets = torch.zeros((), device=dev)
  track, per_step = [], []
  track_params = env.reward_manager.params['track_lin_vel_exp']
  with counted(path):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(ELL_STEPS):
      if i == 10:  # a reset on the path
        tip_over(torch, env, B - 1)
      before = [LAUNCHES[k] for k in kernels]
      obs, rew, term, trunc, extras = env.step(actor(obs))
      per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels,
                                                             before)))
      ok &= torch.isfinite(rew).all() & torch.isfinite(obs['policy']).all() \
          & torch.isfinite(obs['critic']).all()
      nan_count += extras['Episode_Termination/physics_nan']
      fell += extras['Episode_Termination/fell_over']
      resets += extras['reset_count']
      if i >= ELL_STEPS - 50:
        raw = mdp.track_lin_vel_exp(env._make_ctx(env.state), **track_params)
        done = term | trunc
        track.append(torch.where(done, torch.zeros_like(raw), raw).sum()
                     / (~done).sum())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  shapes = sorted(set(per_step))
  track_mean = float(torch.stack(track).mean())
  print(f'G1 elliptic: {ELL_STEPS} env-steps x {B} envs under the shipped '
        f'flat actor in {wall:.3f} s = {ELL_STEPS * B / wall:.1f} '
        f'env-steps/s ({wall / ELL_STEPS * 1e3:.2f} ms an env-step); resets '
        f'{int(resets)}, fell_over {int(fell)} ({float(fell) / B:.4f} of '
        f'envs), physics_nan {int(nan_count)}, mean raw track_lin_vel_exp '
        f'over the last 50 steps {track_mean:.4f}; launches per env-step '
        f'(K3, K2, K1, K3 per env) { {s_: per_step.count(s_) for s_ in shapes} }'
        f' (predicted {sorted(allowed)}); card {card}', flush=True)
  check(bool(ok), 'non-finite observation or reward on the elliptic path')
  check(int(nan_count) == 0, f'physics_nan fired {int(nan_count)} times on '
        'the elliptic path')
  check(set(shapes) == allowed, f'an elliptic env-step launched {shapes}, '
        f'not {sorted(allowed)}')
  act = actor(obs)

  def three_steps():
    for _ in range(3):
      env.step(act)

  with counted(path):
    _, syncs = count_syncs(torch, three_steps)
  print(f'G1 elliptic: {len(syncs)} synchronizing calls in 3 env-steps',
        flush=True)
  check(len(syncs) == 3, 'the elliptic env.step synchronizes other than '
        'once a step: ' + '; '.join(sorted(set(syncs))))
  substep_stages(torch, env.state.model, env.state.data, card, 'G1 elliptic')
  del env, obs, act

  argv = [ENV_TASK, '--env.sim.mujoco.cone', 'elliptic', '--log-root', root,
          '--env.scene.num_envs', str(B), '--agent.max_iterations',
          str(TRAIN_ITERS), '--run-name', 'elliptic']
  with counted(path), launches_per_step(kernels) as per_step:
    t0 = time.perf_counter()
    runner = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  shapes = sorted(set(per_step))
  print(f'G1 elliptic train: {TRAIN_ITERS} iterations of '
        f'{runner.cfg.num_steps_per_env} env-steps x {runner.env.num_envs} '
        f'envs through train.main in {wall:.2f} s (env build included), '
        f'cone {runner.env.model.stat.cone}; widths actor '
        f'{runner.cfg.policy.actor_hidden_dims} critic '
        f'{runner.cfg.policy.critic_hidden_dims}; launches per rollout '
        f'env-step { {s_: per_step.count(s_) for s_ in shapes} }', flush=True)
  check(runner.env.model.stat.cone == 1 and per_step.envs == {(B, 'cuda')}
        and set(shapes) <= allowed,
        f'the elliptic training launched {shapes} on {per_step.envs}')
  training_checks(torch, runner, os.path.join(
      root, runner.cfg.experiment_name, 'elliptic'), 'G1 elliptic train',
      card, iters=TRAIN_ITERS, terrain=False)
  del runner

  e_obs, e_rew, same, flips, kept = card_vs_cpu_flips(
      torch, ENV_TASK, lambda: elliptic_cfg(degenerate_ranges(
          registry.load_cfg(ENV_TASK), 8)), 5)
  print(f'G1 elliptic, 8 envs, 5 env-steps, CUDA f32 vs CPU f64: obs '
        f'err/(1+max|cpu|) {e_obs:.3e}, reward {e_rew:.3e} (tolerance 1e-3),'
        f' done flags equal {same}; contact flips (env: env-step, |dist - '
        f'margin| on the CPU in m) '
        f'{ {e: (i, f"{g:.3e}") for e, (i, g) in flips.items()} } (allowed '
        f'within {FLIP_GAP:g} m of the threshold), {kept} envs compared to '
        f'the end', flush=True)
  check(e_obs <= 1e-3 and e_rew <= 1e-3 and same,
        'the elliptic env on the card disagrees with the CPU')
  check(all(g <= FLIP_GAP for _, g in flips.values()) and kept >= 6,
        'a contact flipped between the card and the CPU away from its '
        'threshold, or in more than two envs')
  return dict(path)


SHARD_ITERS = 3  # PPO iterations of phase 13a's runs
SHARD2_ITERS = 2  # of phase 13b's 2-rank run
# phase 13 trains with one minibatch an epoch: a sharded rank's minibatches
# are stratified by rank (rl/ppo.py), so only a whole-batch minibatch is the
# same sample set as the unsharded run's, which 13a and 13b compare with
SHARD_ARGS = ('--agent.algorithm.num_mini_batches', '1')
# ... and the compared runs clip the actions to 0, so that the rollout does
# not depend on the policy's float32 products, which cuBLAS rounds
# differently at 2048 and at 4096 rows; 24 env-steps of falling G1s grow
# that: with the policy's actions, 13b's iteration-1 kl was 0.7 % and a few
# parameters ~3e-3 from the unsharded run's on an H100 (PERF.md §6). They
# keep the learning rate fixed, as phase 6c does, so that Adam's sign step
# bounds how far an element whose gradient is within rounding of 0 moves
COMPARED_ARGS = ('--agent.clip_actions', '0.0', '--agent.algorithm.schedule',
                 'fixed')


@contextlib.contextmanager
def recording(torch):
  """Within the block, each PPO learn iteration appends the learner's
  parameters after it (on the CPU) to rec['params'] and Adam's moments to
  rec['adam'] ({'mu': {...}, 'nu': {...}}), the first Adam step puts the
  moments after it in rec['first_adam'], and the first env-step of any
  env puts its observations, reward and done flags in rec['first_step']."""
  from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnv
  from mjlab_torch.rl import ppo
  from mjlab_torch.rl.ppo import PPO
  rec = {'params': [], 'adam': [], 'first_adam': None, 'first_step': None}
  learn, step = PPO.learn_iteration, ManagerBasedRlEnv._step_fn
  adam_step = ppo.adam_step_

  def moments(adam, to='cpu'):
    return {m: {k: v.to(to, copy=True) for k, v in getattr(adam, m).items()}
            for m in ('mu', 'nu')}

  def adam_step_(params, grads, state, lr):
    adam_step(params, grads, state, lr)
    if rec['first_adam'] is None:  # a copy on the card: the update's no sync
      rec['first_adam'] = moments(state, state.count.device)

  def learn_iteration(self, ts):
    ts, logs = learn(self, ts)
    rec['params'].append({k: p.detach().cpu().clone()
                          for k, p in ts.net.named_parameters()})
    rec['adam'].append(moments(ts.adam))
    rec['first_adam'] = {m: {k: v.cpu() for k, v in d.items()}
                         for m, d in rec['first_adam'].items()}
    return ts, logs

  def step_fn(self, *a, **kw):
    state, out = step(self, *a, **kw)
    if rec['first_step'] is None:
      obs, reward, terminated, truncated, _ = out
      rec['first_step'] = {
          **{f'obs/{k}': v.detach().cpu().clone() for k, v in obs.items()},
          'reward': reward.detach().cpu().clone(),
          'done': (terminated | truncated).cpu()}
    return state, out

  PPO.learn_iteration, ManagerBasedRlEnv._step_fn = learn_iteration, step_fn
  ppo.adam_step_ = adam_step_
  try:
    yield rec
  finally:
    PPO.learn_iteration, ManagerBasedRlEnv._step_fn = learn, step
    ppo.adam_step_ = adam_step


@contextlib.contextmanager
def learner_syncs(torch):
  """Within the block, each PPO rollout appends the messages of its
  synchronizing CUDA calls to out['rollout'], and GAE, the update and the
  rollout's logs theirs to out['update'] (count_syncs)."""
  from mjlab_torch.rl.ppo import PPO
  kinds = {'_rollout': 'rollout', '_gae': 'update', '_update': 'update',
           '_rollout_logs': 'update'}
  plain = {name: getattr(PPO, name) for name in kinds}
  out = {'rollout': [], 'update': []}

  def counted_call(name):
    def call(self, *a, **kw):
      res, syncs = count_syncs(torch, lambda: plain[name](self, *a, **kw))
      out[kinds[name]].append(syncs)
      return res
    return call

  for name in kinds:
    setattr(PPO, name, counted_call(name))
  try:
    yield out
  finally:
    for name, fn in plain.items():
      setattr(PPO, name, fn)


def gloo_cuda_probe(torch) -> dict:
  """Which collectives this torch's gloo takes CUDA tensors for, in a
  group of one process: {collective: 'ok' or the error's first line}.
  The port does not depend on it: under gloo every collective of a CUDA
  tensor goes through the host."""
  import torch.distributed as dist
  dist.init_process_group('gloo', store=dist.HashStore(), rank=0,
                          world_size=1)
  x = torch.ones(4, device='cuda')
  calls = {
      'all_reduce': lambda: dist.all_reduce(x.clone()),
      'broadcast': lambda: dist.broadcast(x.clone(), 0),
      'all_gather': lambda: dist.all_gather([torch.empty_like(x)], x),
      'all_gather_into_tensor': lambda: dist.all_gather_into_tensor(
          torch.empty_like(x), x),
      'reduce_scatter_tensor': lambda: dist.reduce_scatter_tensor(
          torch.empty_like(x), x.clone()),
  }
  out = {}
  try:
    for name, call in calls.items():
      try:
        call()
        torch.cuda.synchronize()
        out[name] = 'ok'
      except (RuntimeError, ValueError, NotImplementedError) as e:
        out[name] = f'{type(e).__name__}: {str(e).splitlines()[0][:100]}'
  finally:
    dist.destroy_process_group()
  return out


def shard_rank(argv) -> None:
  """One rank of phase 13b, under torch.distributed.run: `train.main` of
  argv[1:] with its launches counted an env-step and its parameters after
  each iteration and its first env-step recorded, written to
  argv[0]/rank<r>.pt."""
  import collections
  import os

  import torch

  from mjlab_torch.scripts import train
  root, train_argv = argv[0], argv[1:]
  path = collections.Counter()
  with recording(torch) as rec, counted(path), \
      launches_per_step(('smooth', 'newton', 'pd_solve')) as per_step:
    t0 = time.perf_counter()
    runner = train.main(train_argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  w = runner.world
  torch.save({'world': (w.rank, w.size, w.backend),
              'rows': (w.offset, w.n_local), 'device': str(w.device),
              'per_step': list(per_step), 'envs': sorted(per_step.envs),
              'launches': dict(path), 'params': rec['params'],
              'adam': rec['adam'], 'first_adam': rec['first_adam'],
              'first_step': rec['first_step'], 'wall': wall},
             os.path.join(root, f'rank{w.rank}.pt'))


def run_group(cmd, timeout: float) -> subprocess.CompletedProcess:
  """`cmd` in a process group of its own, its output captured; at the
  timeout the whole group (the launcher and its workers) is killed and the
  phase fails."""
  import os
  import signal
  proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                          text=True, start_new_session=True)
  try:
    out, err = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    out, err = proc.communicate()
    fail(f'{cmd[:6]} ran past {timeout} s:\n{out[-2000:]}{err[-4000:]}')
  return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def shard_path(torch, card: str) -> dict:
  """Phase 13: `scripts.train --shard` of G1 flat at 4096 envs. Returns
  the kernels' launches over its runs (each rank's, in 13b)."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_shard_')
  try:
    return _shard_path(torch, card, root)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _shard_path(torch, card: str, root: str) -> dict:
  import collections
  import math
  import os

  from mjlab_torch.envs.io import env_state_to_numpy
  from mjlab_torch.parallel.sharding import free_port
  from mjlab_torch.rl.runner import OnPolicyRunner
  from mjlab_torch.scripts import train
  from mjlab_torch.tasks import registry

  kernels = ('smooth', 'newton', 'pd_solve')
  allowed = {(4, 4, 8), (5, 5, 9)}
  path = collections.Counter()

  def argv(name, iters, *extra):
    return [ENV_TASK, '--log-root', root, '--env.scene.num_envs', str(B),
            *SHARD_ARGS, '--agent.max_iterations', str(iters), '--run-name',
            name, *extra]

  experiment = registry.load_cfg(ENV_TASK, 'rl_cfg_entry_point').experiment_name

  def metrics(name):
    run = os.path.join(root, experiment, name)
    with open(os.path.join(run, 'metrics.jsonl')) as f:
      return run, [json.loads(line) for line in f]

  def run(name, iters, shard, hooks):
    """train.main at 4096 envs; `hooks`: a compared run (actions clipped,
    parameters and first env-step recorded, syncs counted). The launches
    of a sharded run count for the shard path, an unsharded run's for
    none."""
    extra = (['--shard'] if shard else []) + list(
        COMPARED_ARGS if hooks else ())
    with contextlib.ExitStack() as stack:
      rec = stack.enter_context(recording(torch)) if hooks else None
      syncs = stack.enter_context(learner_syncs(torch)) if hooks else None
      if shard:
        stack.enter_context(counted(path))
      per_step = stack.enter_context(launches_per_step(kernels))
      runner = train.main(argv(name, iters, *extra))
      torch.cuda.synchronize()
    run_dir, lines = metrics(name)
    T = runner.cfg.num_steps_per_env
    rate = iters * T * B / lines[-1]['wall_s']
    return runner, rec, syncs, per_step, run_dir, lines, rate

  # ---- 13a: --shard started plainly, a world of one over NCCL ---------------
  a, a_rec, a_syncs, a_steps, a_run, a_lines, a_rate = run(
      'shard1', SHARD_ITERS, True, True)
  T = a.cfg.num_steps_per_env
  w = a.world
  print(f'G1 shard (13a): world of {w.size} over {w.backend}, rank {w.rank}, '
        f'{w.n_local} envs on {w.device}; launches per rollout env-step '
        f'(K3, K2, K1) { {s_: a_steps.count(s_) for s_ in set(a_steps)} }; '
        f'synchronizing calls per rollout {[len(s) for s in a_syncs["rollout"]]}'
        f', in GAE, the update and the logs '
        f'{sum(len(s) for s in a_syncs["update"])} '
        f'{sorted({m for s in a_syncs["update"] for m in s})}', flush=True)
  check(w.size == 1 and w.backend == 'nccl' and w.group is not None,
        f'--shard on one card is not a world of one over NCCL: {w}')
  check(len(a_steps) == SHARD_ITERS * T and set(a_steps) <= allowed
        and a_steps.envs == {(B, 'cuda')},
        f'13a launched {sorted(set(a_steps))} on {a_steps.envs}')
  first = sorted(set(a_syncs['rollout'][0]))
  print(f'G1 shard (13a): the first rollout\'s synchronizing calls (once '
        f'a process: first uses): {first}', flush=True)
  check(all(len(s) == T for s in a_syncs['rollout'][1:])
        and len(a_syncs['rollout']) == SHARD_ITERS,
        'a sharded rollout synchronizes other than once an env-step')
  check(not any(a_syncs['update']), 'the sharded update synchronizes')
  training_checks(torch, a, a_run, 'G1 shard (13a)', card,
                  iters=SHARD_ITERS, terrain=False)
  ckpts = sorted(f for f in os.listdir(a_run) if f.endswith('.pt'))
  check(ckpts == [f'model_{SHARD_ITERS}.pt'], f'13a wrote {ckpts}')

  b, b_rec, b_syncs, b_steps, b_run, b_lines, b_rate = run(
      'plain1', SHARD_ITERS, False, True)
  print(f'G1 unsharded (13a): synchronizing calls per rollout '
        f'{[len(s) for s in b_syncs["rollout"]]}, in GAE, the update and the '
        f'logs {sum(len(s) for s in b_syncs["update"])}', flush=True)
  # the first rollout of a process also waits where a buffer or a
  # collective is first used (the unsharded one too); later ones do not
  check(all(len(s) == T for s in b_syncs['rollout'][1:])
        and not any(b_syncs['update']),
        'the unsharded rollouts synchronize other than once an env-step')
  skip = ('_ms', 'wall_s', 'env_steps_per_s')
  log_err = {k: abs(a_lines[0][k] - v) / (1 + abs(v))
             for k, v in b_lines[0].items() if not k.endswith(skip)}
  par_err = {k: rel_err(a_rec['params'][0][k], v)
             for k, v in b_rec['params'][0].items()}
  worst_log = max(log_err, key=log_err.get)
  worst_par = max(par_err, key=par_err.get)
  same_params = all(torch.equal(a_rec['params'][0][k], v)
                    for k, v in b_rec['params'][0].items())
  print(f'G1 shard (13a) against the unsharded train.main, iteration 1: '
        f'logs err/(1+|plain|) worst {log_err[worst_log]:.3e} ({worst_log}), '
        f'parameters err/(1+max|plain|) worst {par_err[worst_par]:.3e} '
        f'({worst_par}), identical to the bit: {same_params} (tolerance '
        f'1e-5)', flush=True)
  check(set(a_lines[0]) == set(b_lines[0]), 'the sharded logs differ in keys')
  check(log_err[worst_log] <= 1e-5 and par_err[worst_par] <= 1e-5,
        '--shard at a world of one disagrees with the unsharded run')

  # the sharded checkpoint into an unsharded runner, bit for bit; it trains
  env_u = registry.make(ENV_TASK, **{'scene.num_envs': B})
  cfg_u = b.cfg  # a compared run's: fixed learning rate, actions clipped
  fresh = OnPolicyRunner(env_u, cfg_u)
  fresh.load(os.path.join(a_run, f'model_{SHARD_ITERS}.pt'),
             load_env_state=True)
  x, y = a.ts, fresh.ts
  same = (x.iteration == y.iteration == SHARD_ITERS
          and torch.equal(x.lr, y.lr)
          and torch.equal(x.adam.count, y.adam.count)
          and all(torch.equal(p, y.net.get_parameter(k))
                  and torch.equal(x.adam.mu[k], y.adam.mu[k])
                  and torch.equal(x.adam.nu[k], y.adam.nu[k])
                  for k, p in x.net.named_parameters())
          and same_payload(torch, env_state_to_numpy(x.env_state, a.env),
                           env_state_to_numpy(y.env_state, env_u)))
  logs = fresh.learn(1)
  print(f'G1 shard (13a): model_{SHARD_ITERS}.pt loads into an unsharded '
        f'runner bit for bit (learner and env state): {same}; it trains on: '
        f'iteration {fresh.ts.iteration}, loss {logs["loss"]:.4f}', flush=True)
  check(same and math.isfinite(logs['loss']),
        'the sharded checkpoint does not resume unsharded')
  del a, b, fresh, x, y

  # env-steps/s in turns: sharded, unsharded (above, actions clipped,
  # hooks on), then unsharded, sharded under the policy's actions
  rates = {'shard1': a_rate, 'plain1': b_rate}
  for name, shard in (('plain2', False), ('shard2', True)):
    rates[name] = run(name, SHARD_ITERS, shard, False)[-1]
  print(f'G1 shard (13a): training env-steps/s at {B} envs, in turns '
        f'(sharded at a world of one, unsharded, unsharded, sharded; the '
        f'first two with actions clipped to 0, parameters recorded an '
        f'iteration and syncs counted): '
        + ', '.join(f'{k} {v:.1f}' for k, v in rates.items())
        + f'; card {card}', flush=True)

  # ---- 13b: torch.distributed.run, 2 gloo ranks on the one card -------------
  print(f'gloo and CUDA tensors in this torch ({torch.__version__}): '
        f'{gloo_cuda_probe(torch)}', flush=True)
  cmd = [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node',
         '2', '--master_addr', '127.0.0.1', '--master_port', str(free_port()),
         os.path.abspath(__file__), '--shard-rank', root,
         *argv('ranks2', SHARD2_ITERS, '--shard', *COMPARED_ARGS)]
  t0 = time.perf_counter()
  proc = run_group(cmd, 600)
  wall = time.perf_counter() - t0
  for line in proc.stdout.splitlines():
    if line.startswith(('[train] rank', 'it ')):
      print(f'13b: {line}', flush=True)
  check(proc.returncode == 0, f'13b: a rank failed ({proc.returncode}):\n'
        + proc.stdout[-2000:] + proc.stderr[-4000:])
  ranks = [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=True)
           for r in range(2)]
  run2, lines2 = metrics('ranks2')
  T2 = T * SHARD2_ITERS
  for r_ in ranks:
    path.update(r_['launches'])
    steps = r_['per_step']
    print(f'13b rank {r_["world"][0]}: world {r_["world"]}, envs '
          f'{r_["rows"][0]}..{sum(r_["rows"]) - 1} on {r_["device"]}, '
          f'launches per env-step (K3, K2, K1) '
          f'{ {s_: steps.count(s_) for s_ in set(map(tuple, steps))} }, '
          f'launches {r_["launches"]}, train.main {r_["wall"]:.2f} s',
          flush=True)
    check(len(steps) == T2 and set(map(tuple, steps)) <= allowed
          and [tuple(e) for e in r_['envs']] == [(B // 2, 'cuda')],
          f'13b rank {r_["world"][0]} launched {set(map(tuple, steps))}')
  check([r_['world'] for r_ in ranks] == [(0, 2, 'gloo'), (1, 2, 'gloo')],
        f'13b worlds {[r_["world"] for r_ in ranks]}')
  same_ranks = [all(torch.equal(p, ranks[1]['params'][i][k])
                    for k, p in ranks[0]['params'][i].items())
                and all(torch.equal(v, ranks[1]['adam'][i][m][k])
                        for m in ('mu', 'nu')
                        for k, v in ranks[0]['adam'][i][m].items())
                for i in range(SHARD2_ITERS)]
  step_err = {}
  for r_ in ranks:
    rows = slice(r_['rows'][0], sum(r_['rows']))
    for k, v in r_['first_step'].items():
      want = b_rec['first_step'][k][rows]
      if k == 'done':
        step_err['done'] = step_err.get('done', True) and torch.equal(v, want)
      else:
        step_err[k] = max(step_err.get(k, 0.0), rel_err(v, want))
  it1 = {k: abs(lines2[0][k] - b_lines[0][k]) / (1e-5 + 1e-3 * abs(
      b_lines[0][k])) for k in ('loss', 'kl', 'mean_reward')}
  # the parameters by phase 6c's rule: Adam moves an element whose
  # gradient is within rounding of 0 by up to 2 lr a step either way, so
  # every element within 2 lr x steps, and the share beyond lr / 10 under
  # 0.01; and how many pass the JAX package's 1e-3 + 1e-3 |plain|
  lr = cfg_u.algorithm.learning_rate
  n_adam = cfg_u.algorithm.num_learning_epochs
  diffs = {k: (p - b_rec['params'][0][k]).abs()
           for k, p in ranks[0]['params'][0].items()}
  max_diff = max(float(d.max()) for d in diffs.values())
  n_el = sum(d.numel() for d in diffs.values())
  share = sum(int((d > lr / 10).sum()) for d in diffs.values()) / n_el
  beyond = sum(int((d > 1e-3 + 1e-3 * b_rec['params'][0][k].abs()).sum())
               for k, d in diffs.items())
  # Adam's moments by the CPU test's rule, max |diff| over (1 + max
  # |plain|) a tensor (and, printed, over max |plain| alone): held after
  # the first Adam step, whose gradient is the ranks' all-reduced one
  # against one batch's from the same parameters; printed after iteration
  # 1, where Adam's sign steps on elements whose gradient is within
  # rounding of 0 have moved the parameters apart
  def moment_err(got, want, rule):
    err = {f'{m} {k}': rule(v, want[m][k])
           for m in ('mu', 'nu') for k, v in got[m].items()}
    worst = max(err, key=err.get)
    return f'{err[worst]:.3e} ({worst})', err[worst]

  of_max = lambda a, b: max_err(a, b) / (float(b.abs().max()) + 1e-30)
  first_txt, first_m = moment_err(ranks[0]['first_adam'],
                                  b_rec['first_adam'], rel_err)
  first_rel, _ = moment_err(ranks[0]['first_adam'], b_rec['first_adam'],
                            of_max)
  it1_txt, _ = moment_err(ranks[0]['adam'][0], b_rec['adam'][0], rel_err)
  it1_rel, _ = moment_err(ranks[0]['adam'][0], b_rec['adam'][0], of_max)
  print(f'13b: parameters and Adam moments of both ranks identical to the '
        f'bit after each iteration: {same_ranks}; first env-step against the unsharded '
        f'rows, err/(1+max|plain|): '
        + ', '.join(f'{k} {v:.3e}' for k, v in step_err.items()
                    if k != 'done')
        + f' (tolerance 1e-4), done flags equal {step_err["done"]}; '
        f'iteration 1 against the unsharded run, |diff| over (1e-5 + 1e-3 '
        f'|plain|) (passes at 1): '
        + ', '.join(f'{k} {v:.3f}' for k, v in it1.items())
        + f'; parameters after {n_adam} Adam steps: max |diff| {max_diff:.3e}'
        f' (tolerance 2 lr x steps = {2 * lr * n_adam:g}), share over lr/10 '
        f'{share:.2e} (tolerance 0.01), {beyond} of {n_el} elements beyond '
        f'1e-3 + 1e-3 |plain|; Adam\'s moments of the worst tensor, max '
        f'|diff| over (1 + max |plain|): after the first Adam step '
        f'{first_txt} (tolerance 1e-5), after iteration 1 {it1_txt}; over '
        f'max |plain|: {first_rel}, {it1_rel}', flush=True)
  check(all(same_ranks), 'the ranks\' learners differ')
  check(first_m <= 1e-5,
        '13b\'s first Adam step disagrees with the unsharded run\'s')
  check(all(v <= 1e-4 for k, v in step_err.items() if k != 'done')
        and step_err['done'], 'a rank\'s first env-step is not its rows of '
        'the unsharded step')
  check(max(it1.values()) <= 1 and max_diff <= 2 * lr * n_adam + 1e-6
        and share <= 0.01,
        '13b\'s iteration 1 disagrees with the unsharded run')
  ckpts = sorted(f for f in os.listdir(run2) if f.endswith('.pt'))
  check(ckpts == [f'model_{SHARD2_ITERS}.pt'], f'13b wrote {ckpts}')
  fresh = OnPolicyRunner(env_u, cfg_u)
  payload = fresh.load(os.path.join(run2, f'model_{SHARD2_ITERS}.pt'),
                       load_env_state=True)
  n_ckpt = {v.shape[0] for v in payload['obs'].values()}
  same = all(torch.equal(p.cpu(), ranks[0]['params'][-1][k])
             for k, p in fresh.ts.net.named_parameters())
  logs = fresh.learn(1)
  rate2 = SHARD2_ITERS * T * B / lines2[-1]['wall_s']
  print(f'13b: model_{SHARD2_ITERS}.pt holds {n_ckpt} envs, loads into an '
        f'unsharded runner with the ranks\' parameters bit for bit: {same}; '
        f'it trains on at a world of one: loss {logs["loss"]:.4f}; the 2-rank '
        f'run took {wall:.1f} s, {rate2:.1f} training env-steps/s over its '
        f'learn loop (two processes time-sharing one card through gloo: '
        f'recorded, not compared); card {card}', flush=True)
  check(n_ckpt == {B} and same and math.isfinite(logs['loss']),
        '13b\'s checkpoint does not resume at a world of one')
  return dict(path)


ORACLE_SUBSTEPS = 200  # substeps of each oracle model in phase 14 ...
# ... but of one whose equality rows the plain Newton solves: its substep
# takes 250-380 ms of host issue at 4096 envs on an H100 (PERF.md §5). 60
# keeps every end-of-run gate: on the CPU at these states the largest
# residual is 6.2e-3 (joint) and the welded box 0.0705 m off
# (tools/oracle_residual_depth.py; at 100 the CPU gives the card's
# numbers to four digits)
ORACLE_PLAIN_SUBSTEPS = 60
# phase 14's launches a substep of each oracle model, (K3, K2, K1), written
# into PERF.md before the first call on the card: K3 on every tree but the
# mocap one (its gate); K2 only without equality rows (its gate: the
# tendon model, its limit rows in the contact block, and the robot); K1
# for the smooth acceleration, the integrator and, where the plain Newton
# solves, each of its ITERATIONS iterations
ORACLE_LAUNCHES = {'connect': (1, 0, 32), 'weld': (1, 0, 32),
                   'joint': (1, 0, 32), 'fourbar': (1, 0, 32),
                   'mocap_weld': (0, 0, 32), 'tendon': (1, 1, 2),
                   'robot': (1, 1, 2)}
# phase 14's gates on the state each model reaches, written before the
# first call on the card: every equality residual of a model without a
# moving target (m, or the weld's torque-scaled rad) within
# ORACLE_RESIDUAL; the welded box within ORACLE_LAG m of where the weld
# holds it (its target, moving at 2 m/s, plus the compiled offset)
ORACLE_RESIDUAL = 0.01
ORACLE_LAG = 0.12


def oracle_states(torch, m, name: str, batch: int, seed: int):
  """`batch` seeded states of the oracle model `name` (float32, on the
  model's device): qpos0 moved by up to 0.05 and velocities up to 0.3 a
  coordinate; the tendon model's hinges up to 0.8 rad, so the coupling of
  some envs starts past its +-0.5 limit; the robot's base raised by up to
  0.2 m, its foot on the floor in the lower envs; controls drawn in their
  ranges."""
  s, dev = m.stat, m.qpos0.device
  gen = torch.Generator().manual_seed(seed)
  u = lambda *shape: 2.0 * torch.rand(*shape, generator=gen) - 1.0
  qpos = m.qpos0.cpu().float().expand(batch, s.nq) + 0.05 * u(batch, s.nq)
  qvel = 0.3 * u(batch, s.nv)
  if name == 'tendon':
    qpos[:, :2] = 0.8 * u(batch, 2)
  if name == 'robot':
    qpos[:, 2] += 0.1 * (u(batch) + 1.0)
  lo, hi = m.actuator_ctrlrange.cpu().float().unbind(-1)
  ctrl = lo + (hi - lo) * 0.5 * (u(batch, s.nu) + 1.0)
  return (qpos.to(dev), qvel.to(dev), ctrl.to(dev))


def mocap_targets(torch, t: int, batch: int, device):
  """(batch, 1, 3) mocap targets at substep t: the circle of
  tests/test_equality.py's test_mocap_weld_target_parity, each env on its
  own phase."""
  ph = 0.02 * (t + 7 * torch.arange(batch, device=device, dtype=torch.float32))
  return torch.stack([0.3 + 0.2 * torch.sin(ph),
                      torch.full_like(ph, 0.1),
                      1.2 + 0.1 * torch.cos(ph)], -1)[:, None]


def k2_numbers(torch, busy, m, args, what: str) -> dict:
  """K2 on the Newton inputs `args` of the model `m` against its plain
  version (within 1e-3 of (1 + max |plain|)), timed bare, behind a busy
  card and plain; the work its inputs need and its bound."""
  from mjlab_torch.ops import newton as k_newton
  from mjlab_torch.ops.work import bound_ms, newton_work
  from mjlab_torch.physics import solver
  iters, polish, ldof, grad_th = solver.solver_params(m.stat)
  kargs = dict(iterations=iters, ls_polish=polish, ldof=ldof,
               grad_th=grad_th)
  n, ncr, nl = m.stat.nv, args[3].shape[1], len(ldof)
  check(k_newton.fits(n, ncr, nl), f'K2 does not fit {what}')
  got = k_newton.newton_solve_cuda(*args, **kargs)
  want = solver.newton_plain(*args, iters, polish, ldof, grad_th)
  rel = max(rel_err(a, b) for a, b in zip(got, want))
  check(all(bool(torch.isfinite(g).all()) for g in got),
        f'K2 gave non-finite output on {what}')
  check(rel <= 1e-3, f'K2 disagrees with its plain version on {what}: '
        f'{rel:.3e}')
  call = lambda: k_newton.newton_solve_cuda(*args, **kargs)
  need, nc, _, nbytes, flops = newton_work(args, iters,
                                           polish, ldof, grad_th)
  bound, by = bound_ms(nbytes, flops)
  return dict(
      max_abs_err=max_err(got[0], want[0]), rel_err=rel,
      ms=time_ms(torch, call, 20),
      device_ms=time_ms(torch, call, 20, busy=busy),
      plain_ms=time_ms(torch, lambda: solver.newton_plain(
          *args, iters, polish, ldof, grad_th), 5),
      bound_ms=bound, bound_by=by, library_ms=None,
      newton_steps=float(need.double().mean()),
      active_contact_rows=float(nc.double().mean()), widths=(n, ncr, nl),
      smem_bytes=k_newton.newton_smem_bytes(n, ncr, nl))


def newton_hessians(torch, m, args, xargs=None, ne: int = 0):
  """([(H, g) of each plain Newton iteration], the solution) on the inputs
  `args` (and the elliptic block `xargs`): the systems the plain solve
  hands K1."""
  from mjlab_torch.ops import pd_solve as k_pd
  from mjlab_torch.physics import solver
  iters, polish, ldof, grad_th = solver.solver_params(m.stat)
  seen, kernel = [], k_pd.solve_pd

  def recording(H, g):
    seen.append((H.contiguous().clone(), g.contiguous().clone()))
    return kernel(H, g)

  k_pd.solve_pd = recording
  try:
    x, *_ = solver.newton_plain(*args, iters, polish, ldof, grad_th, xargs,
                                ne)
  finally:
    k_pd.solve_pd = kernel
  check(len(seen) == iters, f'the plain Newton called K1 {len(seen)} times, '
        f'not {iters}')
  return seen, x


ORACLE_CPU_ENVS, ORACLE_CPU_STEPS = 8, 20  # phase 14a's card-vs-CPU run


def oracle_card_vs_cpu(torch, arrays, name: str, start, card_states) -> float:
  """Phase 14a's check of the card against the CPU: the first
  ORACLE_CPU_ENVS envs of the 4096-env run (their states after each of its
  first ORACLE_CPU_STEPS substeps, `card_states`, float32) against the port
  on the CPU in float64 from the same `start` (qpos, qvel, ctrl) and mocap
  targets: the largest err/(1 + max |cpu|) over qpos, qvel and
  sensordata."""
  import mjlab_torch.physics as phys
  n = ORACLE_CPU_ENVS
  m = phys.put_model(arrays, device='cpu', dtype=torch.float64)
  qpos, qvel, ctrl = (x[:n].cpu().double() for x in start)
  d = phys.make_batched_data(m, n, device='cpu').replace(
      qpos=qpos, qvel=qvel, ctrl=ctrl)
  worst = 0.0
  for t, card in enumerate(card_states):
    if m.stat.nmocap:
      d = d.replace(mocap_pos=mocap_targets(torch, t, n, 'cpu').double())
    d = phys.step(m, d)
    for f, got in card.items():
      worst = max(worst, rel_err(got.cpu(), getattr(d, f)))
  return worst


def oracle_path(torch, card: str, busy) -> 'tuple[dict, dict]':
  """Phase 14: the engine's oracle models of equality constraints,
  tendons, mocap bodies and sensors (asset_zoo/oracle_models.py) through
  put_model, make_batched_data and step at 4096 envs. Returns (the
  kernels' launches over the counted runs, {kernel: numbers of 14b})."""
  import collections

  import numpy as np

  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import oracle_models as om
  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.ops import pd_solve as k_pd
  from mjlab_torch.ops import smooth_kernel as k_smooth
  from mjlab_torch.physics import constraint, linalg, pipeline, smooth
  from mjlab_torch.physics import smooth_fused, solver

  total = collections.Counter()
  numbers, k3_errs = {}, {}
  kern = ('smooth', 'newton', 'pd_solve')
  for name in ORACLE_LAUNCHES:  # the convex pile is phase 15's
    arrays = om.oracle_arrays(name)
    m = phys.put_model(arrays)
    s = m.stat
    lay = constraint.efc_layout(s)
    qpos, qvel, ctrl = oracle_states(torch, m, name, B, seed=14)
    d = phys.make_batched_data(m, B).replace(qpos=qpos, qvel=qvel,
                                             ctrl=ctrl)
    # ---- 14a: the rows at the start; 200 substeps, launches counted ------
    df = smooth.fwd_smooth(m, smooth.actuation(m, pipeline.fwd_velocity(
        m, pipeline.fwd_position(m, d))))
    efc = constraint.make_efc(m, df)
    args = solver.newton_args(df, efc)
    t_envs = int(efc['t_active'].any(-1).sum()) if lay.nlt else 0
    c_envs = int(efc['c_active'].any(-1).sum())
    steps = ORACLE_PLAIN_SUBSTEPS if lay.ne else ORACLE_SUBSTEPS
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    card_states = []  # the first envs' states for the check against the CPU
    cmp = ('qpos', 'qvel') + (('sensordata',) if s.nsensor else ())
    for t in range(steps):
      if s.nmocap:
        d = d.replace(mocap_pos=mocap_targets(torch, t, B, d.qpos.device))
      d = phys.step(m, d)
      if t < ORACLE_CPU_STEPS:
        card_states.append({f: getattr(d, f)[:ORACLE_CPU_ENVS].clone()
                            for f in cmp})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = tuple(LAUNCHES[k] for k in kern)
    total.update(LAUNCHES)
    want = tuple(steps * k for k in ORACLE_LAUNCHES[name])
    fields = ('qpos', 'qvel', 'qacc', 'efc_force') + (
        ('sensordata',) if s.nsensor else ())
    finite = all(bool(torch.isfinite(getattr(d, f)).all()) for f in fields)
    end = constraint.make_efc(m, smooth.fwd_smooth(m, smooth.actuation(
        m, pipeline.fwd_velocity(m, pipeline.fwd_position(m, d)))))
    resid = float(end['e_pos'].abs().max()) if lay.ne else 0.0
    line = (f'oracle {name}: nv {s.nv}, ne {lay.ne}, nlt {lay.nlt}, ncr '
            f'{lay.ncr}, K3 {smooth_fused.enabled(s)}; {steps} '
            f'substeps x {B} envs in {wall:.3f} s = '
            f'{steps / wall:.1f} substeps/s, '
            f'{steps * B / wall:.1f} env-substeps/s; launches '
            f'(K3, K2, K1) {got}, predicted {want}; envs with active '
            f'tendon-limit rows at the start {t_envs}, with active contact '
            f'rows {c_envs}; max |equality residual| at the end {resid:.3e}')
    lag = None
    if s.nmocap:  # the weld keeps the compiled offset from the target
      box = d.qpos[:, :3]
      offset = m.qpos0[:3] - m.body_pos[int(np.nonzero(
          s.body_mocapid >= 0)[0][0])]
      target = mocap_targets(torch, steps - 1, B, box.device)[:, 0]
      lag = float((box - target - offset).norm(dim=-1).max())
      line += f'; the box at most {lag:.4f} m from where the weld holds it'
    if s.nsensor:
      line += (f'; sensordata max |x| '
               f'{float(d.sensordata.abs().max()):.3e}')
    err = oracle_card_vs_cpu(torch, arrays, name, (qpos, qvel, ctrl),
                             card_states)
    print(f'{line}; its first {ORACLE_CPU_ENVS} envs (card f32) against the '
          f'CPU (f64) over {ORACLE_CPU_STEPS} substeps, worst '
          f'err/(1+max|cpu|) {err:.3e} (tolerance 1e-3); card {card}',
          flush=True)
    check(finite, f'non-finite state after the {name} oracle model')
    check(got == want, f'the {name} oracle model launched (K3, K2, K1) '
          f'{got} in {steps} substeps, not {want}')
    check(s.nmocap or resid <= ORACLE_RESIDUAL, f'the {name} equality '
          f'residual {resid:.3e} exceeds {ORACLE_RESIDUAL}')
    check(err <= 1e-3, f'the {name} oracle model on the card disagrees with '
          f'the CPU: {err:.3e}')
    if name == 'tendon':
      check(t_envs > 0, 'no tendon-limit rows active in the tendon model')
    if lag is not None:
      check(lag <= ORACLE_LAG, f'the welded box is {lag:.4f} m from where '
            'the weld holds it')
    if name == 'robot':
      check(c_envs > 0, 'no contact rows active in the robot model')

    # ---- 14b: K3 on each tree it takes, K2 at the tendon model's and the
    # robot's shapes, K1 on the four-bar's plain Newton Hessians; one
    # four-bar substep by stage -----------------------------------------
    if smooth_fused.enabled(s):
      e3 = k3_rel_err(torch, k_smooth.smooth_fused_cuda(m, qpos, qvel),
                      smooth_fused.plain_all(m, d.replace(
                          qpos=qpos, qvel=qvel)), s.nsite)
      k3_errs[name] = e3
      check(e3 <= 1e-4, f'K3 disagrees with its plain version on the {name} '
            f'oracle model: {e3:.3e}')
    if name in ('tendon', 'robot'):
      k2 = k2_numbers(torch, busy, m, [a.contiguous() for a in args],
                      f'the {name} oracle model')
      numbers.setdefault('newton', {})[f'oracle_{name}'] = k2
      print(f'oracle {name} K2: (n, ncr, nl) {k2["widths"]}, Newton steps '
            f'an env {k2["newton_steps"]:.3f}, active contact-block rows an '
            f'env {k2["active_contact_rows"]:.2f}; max abs err '
            f'{k2["max_abs_err"]:.3e}, err/(1+max|plain|) '
            f'{k2["rel_err"]:.3e} (tolerance 1e-3); {k2["ms"]:.4f} ms, '
            f'{k2["device_ms"]:.4f} ms behind a busy card, plain '
            f'{k2["plain_ms"]:.4f} ms, bound {k2["bound_ms"]:.5f} ms by '
            f'{k2["bound_by"]}; {k2["smem_bytes"]} B of shared memory a '
            f'block; card {card}', flush=True)
    if name == 'fourbar':
      seen, _ = newton_hessians(torch, m, args, ne=lay.ne)
      errs = [rel_err(k_pd.solve_pd_cuda(H, g), linalg.solve_pd(H, g))
              for H, g in seen]
      check(max(errs) <= 1e-4, 'K1 disagrees with its plain version on the '
            f'four-bar Newton Hessians: {max(errs):.3e}')
      k1 = k1_numbers(torch, busy, *seen[-1], 'the four-bar Hessians')
      k1['worst_rel_err_of_the_iterations'] = max(errs)
      numbers.setdefault('pd_solve', {})['oracle_fourbar_hessians'] = k1
      print(f'oracle fourbar K1 on the plain Newton\'s {len(seen)} Hessians '
            f'(n {s.nv}): worst err/(1+max|plain|) {max(errs):.3e} '
            f'(tolerance 1e-4); on the last {k1["ms"]:.4f} ms, '
            f'{k1["device_ms"]:.4f} ms behind a busy card, plain '
            f'{k1["plain_ms"]:.4f} ms, bound {k1["bound_ms"]:.5f} ms by '
            f'{k1["bound_by"]}, library {k1["library_ms"]:.4f} ms; card '
            f'{card}', flush=True)
      stages = substep_stages(torch, m, d, card, 'oracle fourbar')
      eq_ms = time_ms(torch, lambda: constraint.equality_block(
          m, df, m.opt.timestep, True), 5)
      sub_ms = sum(g for g, _ in stages.values())
      print(f'oracle fourbar: the equality block alone {eq_ms:.3f} ms, '
            f'{eq_ms / sub_ms:.3f} of the {sub_ms:.3f} ms substep (events '
            f'around each stage); card {card}', flush=True)
  print('oracle K3 against its plain version at the start, worst output '
        'err/(1+max|plain|) (tolerance 1e-4): ' + ', '.join(
            f'{k} {v:.3e}' for k, v in k3_errs.items()), flush=True)
  numbers['smooth'] = {'oracle_rel_err': k3_errs}
  return total, numbers


PILE_SUBSTEPS = 60  # substeps of phase 15a's counted run at 4096 envs
# phase 15's launches a substep of the convex pile, (K3, K2, K1), written
# into PERF.md before the first call on the card: K3 (nine free bodies on
# the world pass its gate), K2 (no equality rows, pyramidal, n 54 with 248
# contact rows fits its shared memory), K1 in fwd_smooth and in the Euler
# step's implicit damping
PILE_LAUNCHES = (1, 1, 2)
# phase 15's gate, written before the first call on the card: no active
# contact of the last PILE_LAST substeps is deeper than this (m)
PILE_PEN_GATE = 0.02
PILE_LAST = 20
# and no |qvel| of any env passes PILE_QVEL_GATE (m/s or rad/s), nor does
# any body lie more than PILE_FAR_GATE (m) from the grid's centre, at any
# substep (tools/pile_blowup.py finds and replays the envs that would)
PILE_QVEL_GATE, PILE_FAR_GATE = 50.0, 2.0
# phase 15a's card-vs-CPU check: for each of the 18 ported groups, the env
# of its earliest first contact, from the card's state PILE_WINDOW[0]
# substeps before that contact for sum(PILE_WINDOW) substeps on the CPU in
# float64; a contact that is active on one side only must lie within
# PILE_FLIP_GAP (m) of its threshold on the CPU
PILE_WINDOW = (4, 6)
PILE_FLIP_GAP = 1e-4
# the start: nine of the 27 cells of a 3 x 3 x 3 grid PILE_SPACING apart
# whose lowest layer is PILE_BASE above the floor, each body jittered by
# up to PILE_JITTER, turned at random and sent toward the grid's centre at
# PILE_SPEED m/s, spinning at up to PILE_SPIN rad/s about each axis
PILE_SPACING, PILE_BASE, PILE_JITTER = 0.25, 0.13, 0.02
PILE_SPEED, PILE_SPIN = (0.3, 1.2), 3.0
PILE_WIDTHS = (54, 248, 1)  # (n, ncr, limit-row width) of K2 on the pile
# K1-K3's rows of the kernels line, and the numbers each row takes from
# shape_kernels
KERNEL_ROWS = {
    'smooth': ('smooth_fused (K3)', 'mjlab_torch/csrc/smooth.cu',
               'mjlab_tpu/ops/smooth_kernel.py:226'),
    'newton': ('newton_solve (K2)', 'mjlab_torch/csrc/newton.cu',
               'mjlab_tpu/ops/newton.py:40'),
    'pd_solve': ('pd_solve (K1)', 'mjlab_torch/csrc/pd_solve.cu',
                 'mjlab_tpu/ops/pd_solve.py:36')}
ROW_NUMBERS = ('max_abs_err', 'ms', 'device_ms', 'plain_ms', 'bound_ms',
               'bound_by', 'library_ms')
# the pile's pair groups whose colliders this slice ported (the other six,
# plane- and sphere-/capsule-/box- pairs, are the G1's and the oracle
# models')
PILE_GROUPS = (
    'plane-ellipsoid', 'plane-cylinder', 'sphere-ellipsoid',
    'sphere-cylinder', 'capsule-ellipsoid', 'capsule-cylinder',
    'ellipsoid-ellipsoid', 'ellipsoid-cylinder', 'ellipsoid-box',
    'cylinder-cylinder', 'cylinder-box', 'plane-mesh', 'sphere-mesh',
    'capsule-mesh', 'ellipsoid-mesh', 'cylinder-mesh', 'box-mesh',
    'mesh-mesh')


def pair_name(key) -> str:
  from mjlab_torch.physics.types import GeomType
  return '-'.join(GeomType(k).name.lower() for k in key)


def pile_states(torch, m, batch: int, seed: int):
  """`batch` seeded start states of the convex pile (float32, on the
  model's device): its nine bodies in distinct cells of the grid, each
  turned at random and moving toward the grid's centre (PILE_*)."""
  gen = torch.Generator().manual_seed(seed)
  u = lambda *shape: torch.rand(*shape, generator=gen)
  cells = u(batch, 27).argsort(-1)[:, :9]
  ijk = torch.stack([cells % 3, cells // 3 % 3, cells // 9], -1).float()
  centre = torch.tensor([0.0, 0.0, PILE_BASE + PILE_SPACING])
  pos = (centre + (ijk - 1.0) * PILE_SPACING
         + PILE_JITTER * (2.0 * u(batch, 9, 3) - 1.0))
  quat = torch.randn(batch, 9, 4, generator=gen)
  quat = quat / quat.norm(dim=-1, keepdim=True)
  toward = centre - pos
  lo, hi = PILE_SPEED
  speed = lo + (hi - lo) * u(batch, 9, 1)
  vel = speed * toward / toward.norm(dim=-1, keepdim=True).clamp_min(1e-6)
  spin = PILE_SPIN * (2.0 * u(batch, 9, 3) - 1.0)
  dev = m.qpos0.device
  return (torch.cat([pos, quat], -1).reshape(batch, 63).to(dev),
          torch.cat([vel, spin], -1).reshape(batch, 54).to(dev))


def pile_cpu_rollout(qpos, qvel, warm, steps: int) -> list:
  """Phase 15a's CPU side: the convex pile from the states (qpos, qvel,
  qacc_warmstart) (numpy, a few envs) for `steps` substeps in float64 on
  the CPU. Returns, after each substep, (qpos, qvel, dist - includemargin)
  as numpy."""
  import torch

  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import oracle_models as om
  m = phys.put_model(om.oracle_arrays('convex_pile'), device='cpu',
                     dtype=torch.float64)
  d = phys.make_batched_data(m, len(qpos), device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      qacc_warmstart=torch.as_tensor(warm))
  out = []
  for _ in range(steps):
    d = phys.step(m, d)
    c = d.contact
    out.append((d.qpos.numpy(), d.qvel.numpy(),
                (c.dist - c.includemargin).numpy()))
  return out


def pile_windows(torch, groups: dict, active) -> 'tuple[list, dict]':
  """The card-vs-CPU windows of phase 15a from the run's active contacts
  `active` (substeps, envs, slots; bool): for each group in PILE_GROUPS,
  the env whose first active contact of the group comes earliest (the
  lowest env on a tie) and the substep t of that contact; its window
  starts at s = t - PILE_WINDOW[0], moved to lie inside the run. Returns
  ([(env, s)] without repeats, {group: (env, t, s)})."""
  steps = active.shape[0]
  width = sum(PILE_WINDOW)
  picks = {}
  for name in PILE_GROUPS:
    g1s, _, _, base, npts = groups[name]
    hit = active[:, :, base:base + len(g1s) * npts].any(-1)  # (T, B)
    first = torch.where(hit.any(0), hit.float().argmax(0), steps)
    env = int(first.argmin())
    t = int(first[env])
    picks[name] = (env, t, min(max(t - PILE_WINDOW[0], 0), steps - width))
  windows = sorted({(e, s) for e, _, s in picks.values()})
  return windows, picks


def pile_card_vs_cpu(torch, card_states, cpu_states):
  """Phase 15a's check of the card against the CPU over the windows:
  `card_states` the card's states (qpos, qvel and the active contacts,
  float32) after each substep of every window, `cpu_states`
  pile_cpu_rollout's float64 states from the same starts. A contact
  within float32 rounding of its threshold may be active on one side
  only; a window whose active contacts first differ after its substep i
  is compared up to its substep i - 1 (card_vs_cpu_flips). Returns (the
  worst err/(1 + max |cpu|) over qpos and qvel, {window: (substep of its
  flip, |dist - includemargin| there on the CPU)}, [the substeps each
  window was compared over])."""
  n = card_states[0]['qpos'].shape[0]
  keep = torch.ones(n, dtype=torch.bool)
  upto = [len(card_states)] * n
  worst, flips = 0.0, {}
  for t, (card, (qpos, qvel, gap)) in enumerate(zip(card_states,
                                                      cpu_states)):
    gap = torch.as_tensor(gap)
    differ = card['active'].cpu() != (gap < 0)
    for e in torch.nonzero(differ.any(-1) & keep).flatten().tolist():
      flips[e] = (t, float(gap[e][differ[e]].abs().max()))
      keep[e] = False
      upto[e] = t
    for f, want in (('qpos', qpos), ('qvel', qvel)):
      worst = max(worst, rel_err(card[f].cpu()[keep],
                                 torch.as_tensor(want)[keep]))
  return worst, flips, upto


def pile_group_numbers(torch, m, d, card: str) -> None:
  """Prints each ported collider group of the pile at the batch `d`: its
  time between CUDA events and its host issue, the card idle before each
  call (medians of 3). No torch.profiler pass: over the groups' ~110,000
  launches one takes 30-45 s of the script on the H100."""
  from mjlab_torch.physics import collision
  for key, (g1s, g2s, _, _, npts) in m.stat.pairs.groups.items():
    name = pair_name(key)
    if name not in PILE_GROUPS:
      continue
    fn = collision.group_collider(m, key, g1s, g2s)
    fn(d)  # the hull tables' first upload
    ms, host = [], []
    for _ in range(3):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      start.record()
      fn(d)
      end.record()
      host.append((time.perf_counter() - t0) * 1e3)
      end.synchronize()
      ms.append(start.elapsed_time(end))
    ms, host = statistics.median(ms), statistics.median(host)
    print(f'pile group {name}: {len(g1s)} pairs x {npts} points, {ms:.3f} '
          f'ms between events, {host:.3f} ms host issue (medians of 3); '
          f'{d.qpos.shape[0]} envs; card {card}', flush=True)


def pile_path(torch, card: str, busy) -> 'tuple[dict, list]':
  """Phase 15: the convex pile (asset_zoo/oracle_models.py: a plane and
  nine free solids, every collider group of ellipsoids, cylinders and
  meshes) through put_model, make_batched_data and step at 4096 envs.
  Returns (the kernels' launches over the counted run, K1-K3's rows at
  the pile's shapes)."""
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import oracle_models as om
  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.physics import smooth_fused

  arrays = om.oracle_arrays('convex_pile')
  m = phys.put_model(arrays)
  s = m.stat
  dev = m.qpos0.device
  groups = {pair_name(k): v for k, v in s.pairs.groups.items()}
  check(set(PILE_GROUPS) <= set(groups) and len(groups) == 24,
        f'the convex pile\'s groups are {sorted(groups)}')
  qpos, qvel = pile_states(torch, m, B, seed=15)
  d = phys.make_batched_data(m, B).replace(qpos=qpos, qvel=qvel)
  ncon = s.pairs.ncon_max
  t_phase = time.perf_counter()
  count = torch.zeros(ncon, dtype=torch.long, device=dev)
  deepest = torch.full((), float('inf'), device=dev)
  # every env's state before each substep (the last after the run) and
  # its active contacts in each substep, for the bounds and the windows
  states = {'qpos': [d.qpos], 'qvel': [d.qvel],
            'qacc_warmstart': [d.qacc_warmstart]}
  active = []
  kern = ('smooth', 'newton', 'pd_solve')
  # ---- 15a: PILE_SUBSTEPS substeps, launches counted ----------------------
  torch.cuda.synchronize()
  reset_launches()
  t0 = time.perf_counter()
  for t in range(PILE_SUBSTEPS):
    d = phys.step(m, d)
    c = d.contact
    act = c.dist < c.includemargin
    count += act.sum(0)
    if t >= PILE_SUBSTEPS - PILE_LAST:
      deepest = torch.minimum(deepest, torch.where(
          act, c.dist, float('inf')).min())
    for f, hist in states.items():
      hist.append(getattr(d, f))
    active.append(act)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = dict(LAUNCHES)
  got = tuple(launches.get(k, 0) for k in kern)
  want = tuple(PILE_SUBSTEPS * k for k in PILE_LAUNCHES)
  finite = all(bool(torch.isfinite(getattr(d, f)).all())
               for f in ('qpos', 'qvel', 'qacc', 'efc_force'))
  deep = -float(deepest)
  states = {f: torch.stack(v) for f, v in states.items()}  # (T + 1, B, .)
  active = torch.stack(active)  # (T, B, ncon)
  fast = float(states['qvel'].abs().max())
  centre = torch.tensor([0.0, 0.0, PILE_BASE + PILE_SPACING], device=dev)
  far = float((states['qpos'].reshape(PILE_SUBSTEPS + 1, B, 9, 7)[..., :3]
               - centre).norm(dim=-1).max())
  print(f'pile: nv {s.nv}, {ncon} contact slots in 24 groups, K3 '
        f'{smooth_fused.enabled(s)}; {PILE_SUBSTEPS} substeps x {B} envs '
        f'in {wall:.3f} s = {PILE_SUBSTEPS / wall:.2f} substeps/s, '
        f'{PILE_SUBSTEPS * B / wall:.1f} env-substeps/s; launches (K3, K2, '
        f'K1) {got}, predicted {want}; deepest active contact over the last '
        f'{PILE_LAST} substeps {deep:.5f} m (gate {PILE_PEN_GATE}); over '
        f'every env and substep max |qvel| {fast:.4f} (gate '
        f'{PILE_QVEL_GATE}), a body at most {far:.4f} m from the grid\'s '
        f'centre (gate {PILE_FAR_GATE}); card {card}', flush=True)
  ever, hits = active.any(0), active.any(1)  # (B, ncon), (T, ncon)
  first = torch.where(hits.any(0), hits.float().argmax(0), PILE_SUBSTEPS)
  counts = {}
  for name, (g1s, _, _, base, npts) in groups.items():
    sl = slice(base, base + len(g1s) * npts)
    counts[name] = (int(ever[:, sl].any(-1).sum()), int(count[sl].sum()),
                    int(first[sl].min()))
  print('pile active contacts by group over the run, (envs with one, '
        'env-substep contacts, the first substep with one): ' + ', '.join(
            f'{k} {v}' for k, v in counts.items()), flush=True)
  check(finite, 'non-finite state after the convex pile')
  check(got == want, f'the convex pile launched (K3, K2, K1) {got} in '
        f'{PILE_SUBSTEPS} substeps, not {want}')
  idle = [k for k in PILE_GROUPS if counts[k][0] == 0]
  check(not idle, f'no active contact of the groups {idle} in the pile')
  check(deep <= PILE_PEN_GATE, f'an active pile contact {deep:.4f} m deep '
        f'in the last {PILE_LAST} substeps')
  check(fast <= PILE_QVEL_GATE and far <= PILE_FAR_GATE, f'a pile env '
        f'left the bounds: |qvel| {fast:.4g}, a body {far:.4g} m from the '
        'centre')

  # the card against the CPU around each group's first contact
  t_cpu = time.perf_counter()
  windows, picks = pile_windows(torch, groups, active)
  width = sum(PILE_WINDOW)
  env = torch.tensor([e for e, _ in windows], device=dev)
  start = torch.tensor([w for _, w in windows], device=dev)
  steps = start[:, None] + torch.arange(width, device=dev)  # (W, width)
  card_states = [{'qpos': states['qpos'][steps[:, k] + 1, env],
                  'qvel': states['qvel'][steps[:, k] + 1, env],
                  'active': active[steps[:, k], env]} for k in range(width)]
  cpu_states = pile_cpu_rollout(*(states[f][start, env].double().cpu().numpy()
                                  for f in ('qpos', 'qvel',
                                            'qacc_warmstart')), width)
  err, flips, upto = pile_card_vs_cpu(torch, card_states, cpu_states)
  t_cpu = time.perf_counter() - t_cpu
  # a group's first contact is compared when its window's comparison runs
  # through that substep, or its flip (near the threshold) comes there
  seen = {n: upto[windows.index((e, w))] > t - w
          for n, (e, t, w) in picks.items()}
  print(f'pile: {len(windows)} windows of {width} substeps (card f32 '
        f'against the CPU f64 from the card\'s state), worst '
        f'err/(1+max|cpu|) {err:.3e} (tolerance 1e-3); (env, first '
        f'contact, window start) by group: ' + ', '.join(
            f'{n} {v}' for n, v in picks.items())
        + f'; flips (window: substep, |dist - margin| on the CPU) {flips} '
        f'(gate {PILE_FLIP_GAP} m); groups whose first contact was '
        f'compared {sum(seen.values())} of {len(seen)}; {t_cpu:.1f} s; '
        f'card {card}', flush=True)
  check(err <= 1e-3, f'the convex pile on the card disagrees with the CPU: '
        f'{err:.3e}')
  check(all(g <= PILE_FLIP_GAP for _, g in flips.values()), f'a pile '
        f'contact active on one side only lies farther than {PILE_FLIP_GAP} '
        f'm from its threshold: {flips}')
  del states, active, card_states

  # ---- 15b: each new group timed; one substep by stage; K1-K3 -------------
  stamps = [('15a', time.perf_counter())]
  pile_group_numbers(torch, m, d, card)
  stamps.append(('the groups', time.perf_counter()))
  substep_stages(torch, m, d, card, 'pile')
  stamps.append(('the stages', time.perf_counter()))
  k = shape_kernels(torch, card, busy, 'convex pile', m, d, PILE_WIDTHS)
  stamps.append(('K1-K3', time.perf_counter()))
  print('phase 15, s: ' + ', '.join(
      f'{name} {t - prev:.1f}' for (name, t), prev in zip(
          stamps, [t_phase] + [t for _, t in stamps[:-1]])), flush=True)
  rows = []
  for kernel, (name, source, replaces) in KERNEL_ROWS.items():
    rows.append(dict(name=f'{name}, convex pile', route='cuda',
                     source=source, replaces=replaces,
                     launches=launches.get(kernel, 0),
                     **{f: k[kernel][f] for f in ROW_NUMBERS}))
  return launches, rows


RING = 'artifacts/blowups_r4/blowup_ring.npz'  # the JAX package's ring
RING_RECORD = 'artifacts/blowups_r4/replay_fixed.txt'  # ... and its replay
RING_SUBSTEPS = 8  # substeps of phase 16a's replay, as the record's
# phase 16a's launches a substep (K3, K2, K1) of the ring's replay, written
# into PERF.md before the first call on the card: the G1 flat substep's
RING_LAUNCHES = (1, 1, 2)
# phase 16a's tolerance, relative, on each substep's max |qvel|: against
# the record, and against the CPU float64 replay over (1 + its max)
RING_TOL = 1e-3
RING_WIDTHS = (35, 144, 29)  # (n, ncr, limit-row width) of K2 on the G1
RING_STEP_RUNS, RING_STEP_STEPS = 5, 10  # phase 16c's timed runs
# K3's envs a block on the G1 scenes: with the 35 visual mesh geoms (69
# geoms), one env's slice of shared memory is 15,280 B, so 14 envs and the
# tables fit the 227 KB a block may use (16 envs with 34 geoms before);
# predicted from csrc/smooth.cu's Layout before the first call on the card
K3_G1_ENVS_PER_BLOCK = 14


def ring_record(path: str) -> dict:
  """{substep: (median, largest) max |qvel| over the ring} of the record's
  env-f32 replay."""
  with open(path) as f:
    for line in f:
      if line.startswith('{') and '"env-f32"' in line:
        return {r['substep']: (r['qvel_max_p50'], r['qvel_max_max'])
                for r in json.loads(line)['substeps']}
  fail(f'no env-f32 replay in {path}')


def ring_state(torch, batch: dict, num_envs: int):
  """The G1 flat task's model (its options, its per-env geom_friction the
  ring's) and a batch of `num_envs` envs holding the ring's rows tiled, on
  the card, float32."""
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import g1_flat_arrays
  from mjlab_torch.scripts.blowup_replay import STATE_KEYS
  from mjlab_torch.tasks import registry
  cfg = registry.load_cfg(ENV_TASK)
  m = phys.put_model(cfg.sim.mujoco.apply(g1_flat_arrays()),
                     ncon_cap=cfg.sim.nconmax)
  rows = torch.arange(num_envs) % len(batch['qpos'])
  t = lambda x: torch.as_tensor(x)[rows].to(m.qpos0.device)
  d = phys.make_batched_data(m, num_envs).replace(
      **{k: t(batch[k]) for k in STATE_KEYS})
  return m.replace(geom_friction=t(batch['model_geom_friction'])), d


def ring_path(torch, card: str, busy) -> 'tuple[dict, dict]':
  """Phase 16a: the JAX package's round-4 ring on the port's G1 flat task
  at 4096 envs. Returns (the kernels' launches over the env-f32 replay,
  K1-K3's numbers at the ring's state)."""
  import os

  from mjlab_torch.scripts import blowup_replay
  root = os.path.dirname(os.path.abspath(__file__))
  t0 = time.perf_counter()
  batch, reports = blowup_replay.replay(
      os.path.join(root, RING), task=ENV_TASK, substeps=RING_SUBSTEPS,
      variants=('env-f32', 'eng-f32', 'eng-f64'), device='cuda',
      num_envs=B, tile=True)
  t_replay = time.perf_counter() - t0
  by = {r['variant']: r for r in reports}
  n = len(batch['qpos'])
  want = tuple(RING_SUBSTEPS * k for k in RING_LAUNCHES)
  for tag, r in by.items():
    per = tuple(r['launches'].get(k, 0) for k in ('smooth', 'newton',
                                                  'pd_solve'))
    print(f'ring {tag}: {r["envs"]} envs, launches (K3, K2, K1) {per}, '
          f'finite {r["finite"]}, copies_err {r.get("copies_err")}, '
          f'reproduced {r["reproduced"]}', flush=True)
    check(r['finite'], f'the ring\'s {tag} replay went non-finite')
    check(not r['reproduced'], f'the ring\'s {tag} replay blew up')
    if tag == 'eng-f64':
      check(r['envs'] == n and per == (0, 0, 0),
            f'the float64 replay is not the ring\'s {n} envs on the CPU')
      continue
    check(r['envs'] == B, f'the {tag} replay ran {r["envs"]} envs')
    check(per == want, f'the {tag} replay launched (K3, K2, K1) {per}, '
          f'not {want}')
    check(r['copies_err'] == 0.0, f'the copies of a ring row part in the '
          f'{tag} replay: {r["copies_err"]:.3e}')
  rec = ring_record(os.path.join(root, RING_RECORD))
  f32, f64 = by['env-f32']['substeps'], by['eng-f64']['substeps']
  worst_rec = worst_f64 = 0.0
  for a, c in zip(f32, f64):
    p50, top = rec[a['substep']]
    e_rec = max(abs(a['qvel_max_max'] - top) / top,
                abs(a['qvel_max_p50'] - p50) / p50)
    e_f64 = abs(a['qvel_max_max'] - c['qvel_max_max']) / (
        1.0 + c['qvel_max_max'])
    worst_rec, worst_f64 = max(worst_rec, e_rec), max(worst_f64, e_f64)
    print(f'ring substep {a["substep"]}: max |qvel| card {a["qvel_max_max"]}'
          f' (median {a["qvel_max_p50"]}), record {top} ({p50}), CPU f64 '
          f'{c["qvel_max_max"]}; err vs record {e_rec:.3e}, vs f64 '
          f'{e_f64:.3e}', flush=True)
  print(f'ring: worst err vs the record {worst_rec:.3e}, vs the CPU f64 '
        f'{worst_f64:.3e} (tolerance {RING_TOL:g}); eng-f32 peaks '
        f'{[r_["qvel_max_max"] for r_ in by["eng-f32"]["substeps"]]}; replay '
        f'{t_replay:.1f} s; card {card}', flush=True)
  check(worst_rec <= RING_TOL, f'the ring\'s replay on the card is '
        f'{worst_rec:.3e} from the record')
  check(worst_f64 <= RING_TOL, f'the ring\'s replay on the card is '
        f'{worst_f64:.3e} from the CPU float64 replay')
  m, d = ring_state(torch, batch, B)
  k = shape_kernels(torch, card, busy, 'round-4 ring', m, d, RING_WIDTHS,
                    box=False)
  check(k['smooth']['envs_per_block'] == K3_G1_ENVS_PER_BLOCK,
        f'K3 takes {k["smooth"]["envs_per_block"]} G1 envs a block')
  return by['env-f32']['launches'], k


def knees_doubled(cfg):
  """The G1 cfg with the stiffness of the knees' ActuatorCfg (which also
  drives the hip roll joints) doubled."""
  import dataclasses
  robot = cfg.scene.entities['robot']
  robot.actuators = tuple(
      dataclasses.replace(a, stiffness=2 * a.stiffness)
      if '.*_knee_joint' in a.joint_names_expr else a
      for a in robot.actuators)
  return cfg


@contextlib.contextmanager
def without_mujoco():
  """mujoco unimportable inside (as on a GPU host without it)."""
  saved = sys.modules.get('mujoco', 0)
  sys.modules['mujoco'] = None
  try:
    yield
  finally:
    if saved == 0:
      del sys.modules['mujoco']
    else:
      sys.modules['mujoco'] = saved


def route_path(torch) -> None:
  """Phase 16b: every registered task's scene takes its snapshot by digest,
  and an edited cfg is refused before it steps, with mujoco
  unimportable."""
  import os

  from mjlab_torch.asset_zoo import g1_flat_arrays
  from mjlab_torch.scene.scene import Scene, spec_digest, spec_inputs
  from mjlab_torch.tasks import registry
  os.environ['MJLAB_TASKS_MODULES'] = TINY_MODULES
  t0 = time.perf_counter()
  with without_mujoco():
    tasks = sorted(registry.registered_tasks())
    check(len(tasks) == 15, f'{len(tasks)} registered tasks, not 15')
    digests = {}
    for task in tasks:
      cfg = registry.load_cfg(task)
      scene = Scene(cfg.scene, device='cuda')
      check(not scene.composed and scene.mj_model.spec_digest == scene.digest,
            f'{task} did not take its snapshot by digest')
      digests[task] = scene.digest
    cfg = knees_doubled(registry.load_cfg(ENV_TASK))
    try:
      registry.make(ENV_TASK, cfg=cfg, **{'scene.num_envs': 8})
      fail('the edited G1 cfg was made into an env without mujoco')
    except RuntimeError as e:
      msg = str(e)
    edited = spec_digest(spec_inputs(cfg.scene))
    snap = g1_flat_arrays().spec_digest
    check(edited != snap and edited in msg and snap in msg,
          f'the refusal does not name both digests: {msg}')
  print(f'route: {len(tasks)} tasks took their snapshots by digest ('
        + ', '.join(f'{t} {d}' for t, d in digests.items()) + f'); the '
        f'edited cfg refused: {msg}; {time.perf_counter() - t0:.1f} s',
        flush=True)


def step_time(torch, card: str) -> dict:
  """Phase 16c: the G1 flat env-step at 4096 envs on the 69-geom snapshot
  under zero actions, RING_STEP_RUNS runs of RING_STEP_STEPS env-steps
  each: ms an env-step, each run's mean."""
  from mjlab_torch.tasks import registry
  env = registry.make(ENV_TASK, **{'scene.num_envs': B})
  check(env.model.stat.ngeom == 69, f'the G1 has {env.model.stat.ngeom} '
        'geoms')
  env.reset()
  act = torch.zeros(B, env.action_dim, device=env.device)
  for _ in range(3):
    env.step(act)
  runs = []
  for _ in range(RING_STEP_RUNS):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RING_STEP_STEPS):
      env.step(act)
    torch.cuda.synchronize()
    runs.append(1e3 * (time.perf_counter() - t0) / RING_STEP_STEPS)
  print(f'G1 flat env-step, 4096 envs, 69 geoms, zero actions: ms an '
        f'env-step by run {[round(r, 3) for r in runs]}, median '
        f'{statistics.median(runs):.3f} ({B / statistics.median(runs) * 1e3:.1f}'
        f' env-steps/s); card {card}', flush=True)
  return dict(runs_ms=runs, median_ms=statistics.median(runs))


VIDEO_LENGTH = 48  # frames of phase 17a's training videos
RENDER_STEPS = 100  # env-steps of phase 17b's play
RENDER_TILE = 4  # envs phase 17b draws side by side


class _Tee:
  """A stdout that also keeps what is printed (`text`)."""

  def __init__(self, out):
    self.out, self.parts = out, []

  def write(self, x):
    self.parts.append(x)
    return self.out.write(x)

  def flush(self):
    self.out.flush()

  @property
  def text(self) -> str:
    return ''.join(self.parts)


def syncs_per_step(torch, fn):
  """(fn(), the synchronizing CUDA calls from each ManagerBasedRlEnv.step's
  start to the next one's: a step's own and what its caller does with the
  step's output). Counted by torch.cuda.set_sync_debug_mode."""
  import warnings

  from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnv
  marks, plain = [], ManagerBasedRlEnv.step

  def step(self, *a, **kw):
    marks.append(sum('synchroniz' in str(w.message) for w in caught))
    return plain(self, *a, **kw)

  torch.cuda.set_sync_debug_mode('warn')
  ManagerBasedRlEnv.step = step
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      out = fn()
  finally:
    ManagerBasedRlEnv.step = plain
    torch.cuda.set_sync_debug_mode('default')
  return out, [b - a for a, b in zip(marks, marks[1:])]


@contextlib.contextmanager
def made_envs():
  """Within the block, every env `registry.make` makes is appended to the
  yielded list."""
  from mjlab_torch.tasks import registry
  envs, plain = [], registry.make

  def make(*a, **kw):
    envs.append(plain(*a, **kw))
    return envs[-1]

  registry.make = make
  try:
    yield envs
  finally:
    registry.make = plain


def video_path(torch, card: str, keep: dict) -> 'tuple[dict, dict]':
  """Phase 17: training videos, play's --render and the memory guard on G1
  flat at 4096 envs. Returns the kernels' launches on the video path
  (17a's training) and on the render path (17b's play with --render)."""
  import shutil
  import tempfile
  root = tempfile.mkdtemp(prefix='chip_smoke_video_')
  try:
    return _video_path(torch, card, root, keep)
  finally:
    shutil.rmtree(root, ignore_errors=True)


def _video_path(torch, card: str, root: str, keep: dict):
  import dataclasses
  import math
  import os

  import numpy as np

  from mjlab_torch.ops import LAUNCHES, reset_launches
  from mjlab_torch.scripts import play, train
  from mjlab_torch.tasks import registry
  from mjlab_torch.utils import hbm

  kernels = ('smooth', 'newton', 'pd_solve')
  # ---- 17a: 3 iterations through train.main with a video every iteration --
  argv = [ENV_TASK, '--log-root', root, '--env.scene.num_envs', str(B),
          '--agent.max_iterations', str(TRAIN_ITERS), '--run-name', 'v',
          '--agent.video', 'True', '--agent.video_interval', '1',
          '--agent.video_length', str(VIDEO_LENGTH)]
  tee = _Tee(sys.stdout)
  with launches_per_step(kernels) as per_step, \
      contextlib.redirect_stdout(tee):
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    runner = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    video_launches = dict(LAUNCHES)
  cfg, env = runner.cfg, runner.env
  T = cfg.num_steps_per_env
  shapes = sorted(set(per_step))
  print(f'video path: {TRAIN_ITERS} iterations of {T} env-steps x {B} envs '
        f'through train.main with video every iteration in {wall:.2f} s; '
        f'launches per rollout env-step (K3, K2, K1) '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }; launches '
        f'{video_launches}', flush=True)
  check(env.device.type == 'cuda' and env.num_envs == B,
        'the video run is not 4096 envs on the card')
  check(len(per_step) == TRAIN_ITERS * T and
        set(shapes) <= {(4, 4, 8), (5, 5, 9)},
        f'the video run stepped {len(per_step)} times, launching {shapes}')
  run = os.path.join(root, cfg.experiment_name, 'v')
  with open(os.path.join(run, 'metrics.jsonl')) as f:
    lines = [json.loads(line) for line in f]
  print(f'video path: collection ms an iteration with video '
        f'{[round(l_["collection_ms"], 1) for l_ in lines]} (logged '
        f'iterations), without (phase 6a) '
        f'{[round(x, 1) for x in keep["collection_ms"]]}; card {card}',
        flush=True)
  nq = env.model.stat.nq
  final = runner.ts.env_state.data.qpos[0].cpu().numpy()
  for k in range(1, TRAIN_ITERS + 1):
    path = os.path.join(run, 'videos', 'train',
                        f'rl-video-iter-{k}.mp4.qpos.npy')
    check(os.path.exists(path), f'{path} was not written')
    frames = np.load(path)
    want = (min(VIDEO_LENGTH, T * k), nq)
    print(f'video path: {os.path.basename(path)} {frames.shape} '
          f'{frames.dtype}, finite {bool(np.isfinite(frames).all())}',
          flush=True)
    check(frames.shape == want and bool(np.isfinite(frames).all()),
          f'{path} holds {frames.shape}, not a finite {want}')
  last = np.array_equal(frames[-1], final)
  said = [l_ for l_ in tee.text.splitlines() if l_.startswith('[viewer]')]
  print(f'video path: the last frame is env 0\'s final qpos bit for bit: '
        f'{last}; the render branch said {said[-1:]!r}', flush=True)
  check(last, 'the last video frame is not env 0\'s final qpos')
  check(len(said) == TRAIN_ITERS and all('no mujoco' in l_ for l_ in said),
        'the render branch did not name the missing mujoco')
  a = torch.load(os.path.join(run, f'model_{TRAIN_ITERS}.pt'),
                 weights_only=True)
  b = torch.load(keep['ckpt'], weights_only=True)
  same = same_payload(torch, a, b)
  print(f'video path: model_{TRAIN_ITERS}.pt equals phase 6a\'s (the same '
        f'run without video) key for key and bit for bit: {same}',
        flush=True)
  check(same, 'recording videos changed the checkpoint')
  del a, b
  alg, ts = runner.alg, runner.ts
  _, roll_syncs = count_syncs(torch, lambda: alg._rollout(ts))
  torch.cuda.synchronize()
  print(f'video path: {len(roll_syncs)} synchronizing calls in a recording '
        f'rollout of {T} env-steps', flush=True)
  check(alg.record_qpos and len(roll_syncs) == T,
        'the recording rollout synchronizes other than once an env-step')
  # what the record costs a rollout: rollouts of the same runner without
  # and with it, in turns
  ms = {False: [], True: []}
  for rec in (False, True, True, False):
    alg.record_qpos = rec
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alg._rollout(ts)
    torch.cuda.synchronize()
    ms[rec].append((time.perf_counter() - t0) * 1e3)
  print(f'video path: a rollout of {T} env-steps x {B} envs without the '
        f'record {[round(x, 1) for x in ms[False]]} ms, with it '
        f'{[round(x, 1) for x in ms[True]]} ms (in turns: without, with, '
        f'with, without); card {card}', flush=True)
  del runner, alg, ts, env

  # ---- 17b: play of the shipped policy with --render ----------------------
  play_argv = [ENV_TASK + '-Play', '--agent', 'trained', '--num-envs', str(B),
               '--steps', str(RENDER_STEPS), '--log-root',
               os.path.join(root, 'none')]
  plain, plain_syncs = syncs_per_step(torch, lambda: play.main(play_argv))
  out = os.path.join(root, 'play.mp4')
  with made_envs() as envs:
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    stats, syncs = syncs_per_step(torch, lambda: play.main(
        play_argv + ['--render', out, '--tile', str(RENDER_TILE)]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    render_launches = dict(LAUNCHES)
  (penv,) = envs
  traj = np.load(out + '.qpos.npy')
  final = penv.state.data.qpos[:RENDER_TILE].cpu().numpy()
  print(f'render path: play of the shipped policy, {RENDER_STEPS} env-steps '
        f'x {B} envs with --render --tile {RENDER_TILE} in {wall:.2f} s; '
        f'launches {render_launches}; statistics equal to the play without '
        f'--render: {stats == plain}; synchronizing calls an env-step '
        f'{sorted(set(syncs))} with --render, {sorted(set(plain_syncs))} '
        f'without; trajectory {traj.shape}, '
        f'finite {bool(np.isfinite(traj).all())}, last frame rows '
        f'0-{RENDER_TILE - 1} of the final qpos bit for bit: '
        f'{np.array_equal(traj[-1], final)}; card {card}', flush=True)
  check(stats == plain, 'play with --render changed the statistics')
  check(syncs == plain_syncs and len(syncs) == RENDER_STEPS - 1,
        'play with --render reads the device more often an env-step')
  check(traj.shape == (RENDER_STEPS, RENDER_TILE, penv.model.stat.nq)
        and bool(np.isfinite(traj).all())
        and np.array_equal(traj[-1], final),
        'the rendered trajectory is not the envs\' qpos')
  check(math.isfinite(stats['mean_reward']), 'play gave a non-finite reward')
  del envs, penv

  # ---- 17c: the memory guard on one env-step ------------------------------
  env = registry.make(ENV_TASK, **{'scene.num_envs': B})
  env.reset()
  act = torch.zeros(B, env.action_dim, device='cuda')
  rep = hbm.memory_report(env.step, act)
  check(rep is not None, 'the memory guard measured nothing on the card')
  fits = hbm.assert_fits(rep, label=f'env.step @{B}')
  small = dataclasses.replace(rep, capacity_bytes=rep.peak_bytes // 2)
  try:
    hbm.assert_fits(small, label=f'env.step @{B}')
    refused = ''
  except hbm.HbmWouldOverflowError as e:
    refused = str(e)
  print(f'memory guard: one G1 flat env-step at {B} envs, peak '
        f'{rep.peak_bytes} B ({rep.peak_bytes / B:.1f} B an env; '
        f'{rep.baseline_bytes} B held before the step), capacity '
        f'{rep.capacity_bytes} B; fits: {fits is rep}; at half the peak '
        f'refused: {refused[:120]!r}; card {card}', flush=True)
  check(fits is rep and refused.startswith(f'env.step @{B}: '),
        'the memory guard did not pass the step or refuse it at half')
  return video_launches, render_launches


PROFILE_REPS = 5  # --reps of phase 18's two runs of scripts/profile.py
# the stages of the profile's report, in the JAX script's order
PROFILE_LABELS = ('full substep (fused)', 'kinematics', 'com_pos', 'crb',
                  'collision narrowphase', 'transmission', 'com_vel',
                  'passive', 'rne', 'actuation', 'fwd_smooth', 'make_efc',
                  'make_efc + solve')
# the kernels' function names, as the trace's device events carry them
PROFILE_KERNELS = {'smooth': 'smooth_kernel', 'newton': 'newton_kernel',
                   'pd_solve': 'pd_solve_kernel',
                   'contact_rows': 'contact_rows_kernel'}


def profile_path(torch, card: str) -> dict:
  """Phase 18: scripts/profile.py through its parser at the registered G1
  flat task and 4096 envs, with --trace and then with --roofline. Returns
  the kernels' launches over both runs."""
  import collections
  import math
  import shutil
  import tempfile

  from mjlab_torch.ops.work import F32_FLOPS_PER_S
  from mjlab_torch.scripts import profile

  argv = ['--task', ENV_TASK, '--num-envs', str(B), '--reps',
          str(PROFILE_REPS)]
  launches = collections.Counter()
  root = tempfile.mkdtemp(prefix='chip_smoke_profile_')
  try:
    with counted(launches), launches_per_step(
        ('smooth', 'newton', 'pd_solve')) as per_step:
      t0 = time.perf_counter()
      traced = profile.main(argv + ['--trace', root])
      t_trace = time.perf_counter() - t0
      roof = profile.main(argv + ['--roofline'])
      t_roof = time.perf_counter() - t0 - t_trace
    trace = traced['trace']
    with open(trace['path']) as f:
      trace_text = f.read()
  finally:
    shutil.rmtree(root, ignore_errors=True)

  # the stage report: every label, in order, each timed
  phases = traced['phases']
  print(f'profile path: stages (ms) '
        f'{ {k: round(v * 1e3, 4) for k, v in phases.items()} }; env-step '
        f'{traced["env_step_s"] * 1e3:.3f} ms (--trace run), '
        f'{roof["env_step_s"] * 1e3:.3f} ms (--roofline run); card {card}',
        flush=True)
  check(tuple(phases) == PROFILE_LABELS,
        f'the profile printed the stages {tuple(phases)}')
  check(all(math.isfinite(v) and v > 0 for v in phases.values()),
        'a stage of the profile has no finite time above 0')
  for r in (traced, roof):
    check(math.isfinite(r['env_step_s']) and r['env_step_s'] > 0,
          'the profile\'s env-step has no finite time above 0')

  # every env-step of both runs went through K1-K3
  shapes = sorted(set(per_step))
  print(f'profile path launches per env-step (K3, K2, K1): '
        f'{ {s_: per_step.count(s_) for s_ in shapes} } over {len(per_step)} '
        f'env-steps; launches {dict(launches)}', flush=True)
  check(per_step.envs == {(B, 'cuda')},
        f'the profile stepped envs {per_step.envs}')
  check(len(per_step) >= 2 * (PROFILE_REPS + 1),
        f'the profile took {len(per_step)} env-steps')
  check(set(shapes) <= {(4, 4, 8), (5, 5, 9)},
        f'a profile env-step launched {shapes}, not 4/4/8 or 5/5/9')

  # the trace names the four kernels among its device events
  named = {k: [n for n in trace['kernels'] if fn in n]
           for k, fn in PROFILE_KERNELS.items()}
  print(f'profile trace: {len(trace_text)} bytes, {len(trace["kernels"])} '
        f'device kernels, {len(trace["host"])} host ops; the kernels\' '
        f'device ms '
        f'{ {k: round(sum(trace["kernels"][n] for n in v), 4) for k, v in named.items()} }'
        f'; memory counters: {trace["counters"]}', flush=True)
  for k, fn in PROFILE_KERNELS.items():
    check(named[k] and fn in trace_text,
          f'the profile\'s trace has no device event of {fn}')

  # the roofline: finite counts above 0, no more FLOP/s than the peak
  for name in ('physics substep', 'full env.step'):
    r = roof['roofline'][name]
    rate = r['flops'] / r['seconds']
    print(f'profile roofline, {name}: {r["flops"]} FLOPs, {r["bytes"]} '
          f'bytes in {r["seconds"] * 1e3:.3f} ms: {rate / 1e12:.4f} TFLOP/s '
          f'({100 * rate / F32_FLOPS_PER_S:.2f} % of the f32 peak), '
          f'{r["bytes"] / r["seconds"] / 1e9:.1f} GB/s apparent; {r["ops"]} '
          f'aten ops; kernels (calls, bytes, FLOPs) {r["kernels"]}; card '
          f'{card}', flush=True)
    check(all(math.isfinite(v) and v > 0 for v in (r['flops'], r['bytes'])),
          f'the roofline of the {name} has no finite count above 0')
    check(rate <= F32_FLOPS_PER_S,
          f'the roofline of the {name} reads {rate:.4g} FLOP/s, over the '
          'f32 peak: the counter is wrong')
    check(set(r['kernels']) == set(PROFILE_KERNELS),
          f'the {name} charged the kernels {sorted(r["kernels"])}')
  print(f'phase 18: the --trace run {t_trace:.1f} s, the --roofline run '
        f'{t_roof:.1f} s', flush=True)
  return launches


WRENCH_STEPS = 150  # env-steps of phase 19a
WRENCH_TIP = 120  # the env-step before which phase 19a tips envs over
WRENCH_TIPPED = 16  # ... the first this many
WRENCH_CPU_ENVS = 256  # envs of phase 19c's xfrc_accumulate on the CPU
# phase 19b's card-vs-CPU cfg: every range a point, a wrench every other
# env-step (tests/test_torch_wrench.py runs the same against the JAX env)
WRENCH_POINT = dict(interval_range_s=(0.04, 0.04), force_range=(6.0, 6.0),
                    torque_range=(-1.5, -1.5))


def wrench_card_vs_cpu(torch, num_envs: int = 8, steps: int = 5):
  """G1 flat with the torso wrench, every range a point, on the card
  against the CPU (card_vs_cpu_flips)."""
  from mjlab_torch.envs import mdp as env_mdp
  from mjlab_torch.managers import term_cfg
  from mjlab_torch.tasks import registry

  def make_cfg():
    return external_wrench(
        degenerate_ranges(registry.load_cfg(ENV_TASK), num_envs), env_mdp,
        term_cfg, **WRENCH_POINT)

  return card_vs_cpu_flips(torch, ENV_TASK, make_cfg, steps)


def wrench_path(torch, card: str, busy) -> dict:
  """Phase 19: G1 flat at 4096 envs under random torso wrenches
  (`external_wrench`: a new wrench on each env every 1-3 s, force in
  +-20 N and torque in +-5 N m a component) and the shipped actor.
  Returns the kernels' launches over the path's run (the env's build and
  reset, and the 150 env-steps)."""
  import collections

  from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
  from mjlab_torch.envs import mdp as env_mdp
  from mjlab_torch.managers import term_cfg
  from mjlab_torch.ops import LAUNCHES
  from mjlab_torch.physics import smooth, smooth_fused
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.tasks import registry

  t19 = time.perf_counter()
  kernels = ('smooth', 'newton', 'pd_solve')
  path = collections.Counter()

  # ---- 19a: build, reset, 150 env-steps under the shipped actor ----------
  cfg = external_wrench(registry.load_cfg(ENV_TASK), env_mdp, term_cfg)
  cfg.scene.num_envs = B
  actor = load_actor(G1_FLAT_POLICY)
  with counted(path):
    env = registry.make(ENV_TASK, cfg=cfg)  # cuda, float32
    obs, _ = env.reset()
  dev = env.device
  view = env.scene['robot']
  torso = int(view.idx.body_ids[view.idx.body_names.index(WRENCH_BODY)])
  clock = 'torso_wrench/time_left'
  dt = env.step_dt
  check(not bool(env.state.data.xfrc_applied.any()),
        'a wrench before the first interval')
  zero = lambda dtype=torch.long: torch.zeros((), dtype=dtype, device=dev)
  armed = torch.zeros(B, dtype=torch.bool, device=dev)
  ever = torch.zeros(B, dtype=torch.bool, device=dev)
  wrong, cleared, fired_any = zero(), zero(), zero()
  outside, elsewhere = zero(torch.bool), zero(torch.bool)
  nan_count, fell = zero(), zero(torch.float32)
  tipped_armed = zero()
  ok = torch.ones((), dtype=torch.bool, device=dev)
  per_step, events = [], []
  lim = torch.tensor(WRENCH_FORCE[1:] * 3 + WRENCH_TORQUE[1:] * 3,
                     device=dev)
  others = torch.tensor([b for b in range(env.model.stat.nbody)
                         if b != torso], device=dev)
  with counted(path):
    for i in range(WRENCH_STEPS):
      if i == WRENCH_TIP:
        tipped_armed = armed[:WRENCH_TIPPED].sum()
        for e in range(WRENCH_TIPPED):
          env._state = tip_over_state(torch, env.state, e)
      left = env.state.event[clock]
      act = actor(obs)
      before = [LAUNCHES[k] for k in kernels]
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      obs, rew, term, trunc, extras = env.step(act)
      end.record()
      events.append((start, end))
      per_step.append(tuple(LAUNCHES[k] - b for k, b in zip(kernels,
                                                             before)))
      # the wrench's bookkeeping, on the card: an env carries a wrench
      # from its interval's first firing until its next reset
      done = term | trunc
      fired = env.state.event[clock] > left - dt / 2
      was = armed
      armed = fired | (armed & ~done)
      x = env.state.data.xfrc_applied
      on = x[:, torso].abs().amax(-1) > 0
      wrong += (on != armed).sum()
      cleared += (done & was & ~fired).sum()
      fired_any += fired.sum()
      ever |= fired
      outside |= (x[:, torso].abs() > lim).any()
      elsewhere |= x.index_select(1, others).any()
      ok &= torch.isfinite(obs['policy']).all() & torch.isfinite(rew).all()
      nan_count += extras['Episode_Termination/physics_nan']
      fell += extras['Episode_Termination/fell_over']
  torch.cuda.synchronize()
  step_ms = [s.elapsed_time(e) for s, e in events]
  shapes = sorted(set(per_step))
  tipped = per_step[WRENCH_TIP]
  fell_share = float(fell) / B
  print(f'wrench path: {WRENCH_STEPS} env-steps x {B} envs, a wrench on '
        f'{WRENCH_BODY} every {WRENCH_INTERVAL_S} s (force {WRENCH_FORCE} N, '
        f'torque {WRENCH_TORQUE} N m a component), the shipped actor: '
        f'env-step median {statistics.median(step_ms):.3f} ms (min '
        f'{min(step_ms):.3f}, max {max(step_ms):.3f}; an event pair around '
        f'env.step); fell_over {int(fell)} ({fell_share:.4f} of envs), '
        f'physics_nan {int(nan_count)}; intervals fired {int(fired_any)} '
        f'on {int(ever.sum())} envs, envs carrying a wrench at the end '
        f'{int(armed.sum())}; card {card}',
        flush=True)
  print(f'wrench path launches per env-step (K3, K2, K1): '
        f'{ {s_: per_step.count(s_) for s_ in shapes} }; the step after '
        f'{WRENCH_TIPPED} envs were tipped over {tipped}', flush=True)
  print(f'wrench path: envs whose torso wrench was not what its intervals '
        f'and resets make it, summed over the env-steps: {int(wrong)}; '
        f'resets that cleared a wrench {int(cleared)} ({int(tipped_armed)} '
        f'of the {WRENCH_TIPPED} tipped envs carried one); a component '
        f'outside its range {bool(outside)}; a wrench on another body '
        f'{bool(elsewhere)}', flush=True)
  check(set(shapes) <= {(4, 4, 8), (5, 5, 9)} and tipped == (5, 5, 9),
        f'a wrench env-step launched {shapes}, the tipped step {tipped}: not '
        '4/4/8, or 5/5/9 with a reset')
  check(bool(ok), 'non-finite observation or reward on the wrench path')
  check(int(nan_count) == 0, f'physics_nan fired {int(nan_count)} times')
  check(int(wrong) == 0, 'an env\'s torso wrench was zero after its '
        'interval fired, or nonzero after a reset')
  check(int(cleared) >= 1 and int(tipped_armed) >= 1,
        'no reset cleared a wrench')
  # an interval of up to 3 s: nearly every env's first one ends inside
  # the 150 env-steps
  check(int(ever.sum()) >= 0.95 * B and not bool(outside)
        and not bool(elsewhere), 'the intervals fired on under 95 % of the '
        'envs, or a wrench left its range or its body')

  # one sync an env-step: the refresh's bool(done.any())
  act = actor(obs)

  def three_steps():
    for _ in range(3):
      env.step(act)

  _, syncs = count_syncs(torch, three_steps)
  print(f'wrench path: {len(syncs)} synchronizing calls in 3 env-steps',
        flush=True)
  check(len(syncs) == 3, 'the wrench env-step synchronizes other than once '
        'a step: ' + '; '.join(sorted(set(syncs))))

  # ---- 19b: 8 envs on the card against the CPU ----------------------------
  e_obs, e_rew, same, flips, kept = wrench_card_vs_cpu(torch)
  tol = 1e-3  # phase 5c's
  print(f'wrench env, 8 envs, 5 env-steps, a wrench every other env-step, '
        f'CUDA f32 vs CPU f64: obs err/(1+max|cpu|) {e_obs:.3e}, reward '
        f'{e_rew:.3e} (tolerance {tol:g}), done flags equal {same}; contact '
        f'flips (env: env-step, |dist - margin| on the CPU in m) '
        f'{ {e: (i, f"{g:.3e}") for e, (i, g) in flips.items()} } (allowed '
        f'within {FLIP_GAP:g} m of the threshold), {kept} envs compared to '
        'the end', flush=True)
  check(e_obs <= tol and e_rew <= tol and same,
        'the wrench env on the card disagrees with the CPU')
  check(all(g <= FLIP_GAP for _, g in flips.values()) and kept >= 6,
        'a contact flipped between the card and the CPU away from its '
        'threshold, or in more than two envs')

  # ---- 19c: xfrc_accumulate on K3's outputs against the CPU ----------------
  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import g1_flat_arrays
  gen = torch.Generator(device=dev).manual_seed(19)
  d = env.state.data
  wrench = torch.zeros_like(d.xfrc_applied)
  wrench[:, torso] = (torch.rand((B, 6), generator=gen, device=dev) * 2 - 1
                      ) * lim
  d = d.replace(xfrc_applied=wrench)
  m = env.state.model
  k3 = LAUNCHES['smooth']
  dk = smooth_fused.smooth_all(m, d)  # K3
  check(LAUNCHES['smooth'] == k3 + 1, 'smooth_all did not launch K3')
  card_x = smooth.xfrc_accumulate(m, dk)
  n = WRENCH_CPU_ENVS
  mc = phys.put_model(g1_flat_arrays(), device='cpu', dtype=torch.float64)
  dc = phys.make_batched_data(mc, n, device='cpu').replace(
      qpos=d.qpos[:n].double().cpu(), qvel=d.qvel[:n].double().cpu(),
      xfrc_applied=wrench[:n].double().cpu())
  cpu_x = smooth.xfrc_accumulate(mc, smooth_fused.plain_all(mc, dc))
  x_err = rel_err(card_x[:n].cpu(), cpu_x)
  tol_x = 1e-4  # K3's tolerance: the inputs are its outputs
  print(f'xfrc_accumulate on K3\'s outputs, {n} envs of the wrench path\'s '
        f'last state with a random torso wrench, CUDA f32 vs CPU f64 plain '
        f'stages: err/(1+max|cpu|) {x_err:.3e} (tolerance {tol_x:g}), '
        f'max |cpu| {float(cpu_x.abs().max()):.3f}', flush=True)
  check(x_err <= tol_x, 'xfrc_accumulate on the card disagrees with the CPU')

  # ---- 19d: xfrc_accumulate alone at 4096 envs; its device kernels ---------
  dz = dk.replace(xfrc_applied=torch.zeros_like(wrench))
  times = {}
  for what, dd in (('zero', dz), ('nonzero', dk)):
    times[what] = (time_ms(torch, lambda: smooth.xfrc_accumulate(m, dd), 20),
                   time_ms(torch, lambda: smooth.xfrc_accumulate(m, dd), 20,
                           busy=busy))
  print(f'xfrc_accumulate alone, {B} envs: zero wrench '
        f'{times["zero"][0]:.4f} ms ({times["zero"][1]:.4f} ms behind a busy '
        f'card), nonzero {times["nonzero"][0]:.4f} ms '
        f'({times["nonzero"][1]:.4f}); event pairs, median of 20; card '
        f'{card}', flush=True)
  from torch.profiler import ProfilerActivity, profile
  smooth.xfrc_accumulate(m, dk)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    smooth.xfrc_accumulate(m, dk)
    torch.cuda.synchronize()
  dev_us = lambda e: getattr(e, 'self_device_time_total',
                             getattr(e, 'self_cuda_time_total', 0))
  kern = sorted(((e.key, e.count, dev_us(e)) for e in prof.key_averages()
                 if str(e.device_type).endswith('CUDA')),
                key=lambda k: -k[2])
  print(f'xfrc_accumulate, one call at {B} envs under torch.profiler: '
        f'{len(kern)} device kernels, '
        f'{sum(k[2] for k in kern) / 1e3:.4f} ms of device time: '
        + '; '.join(f'{name[:100]} x{c} {us / 1e3:.4f} ms'
                    for name, c, us in kern) + f'; card {card}', flush=True)
  if not kern:
    print('xfrc_accumulate: the profiler saw no device time', flush=True)
  print(f'phase 19 {time.perf_counter() - t19:.1f} s', flush=True)
  return path


def main() -> None:
  import torch
  if not torch.cuda.is_available():
    fail('torch.cuda.is_available() is false: this script needs a GPU')
  t_script = time.perf_counter()

  def stamp(phase: str) -> None:  # where the script's time goes
    print(f'{phase} ends {time.perf_counter() - t_script:.1f} s into the '
          'script', flush=True)

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False

  import mjlab_torch.physics as phys
  from mjlab_torch.asset_zoo import g1_flat_arrays
  from mjlab_torch.ops import LAUNCHES, build_all, reset_launches
  from mjlab_torch.ops import newton as k_newton
  from mjlab_torch.ops import pd_solve as k_pd
  from mjlab_torch.ops import smooth_kernel as k_smooth
  from mjlab_torch.ops.work import (bound_ms, k3_work, newton_work,
                                     pd_solve_work)
  from mjlab_torch.physics import constraint, linalg, pipeline
  from mjlab_torch.physics import smooth, smooth_fused, solver

  # ---- phase 1: the card, the build --------------------------------------
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  print(card, flush=True)
  t0 = time.perf_counter()
  built = build_all()
  print(f'build: {time.perf_counter() - t0:.1f} s wall, per source '
        f'{ {k: round(v, 1) for k, v in built.items()} }', flush=True)

  dev = torch.device('cuda')
  mj = g1_flat_arrays()  # the committed G1 flat scene
  m = phys.put_model(mj)  # cuda, float32
  s = m.stat
  dt = m.opt.timestep
  gen = torch.Generator().manual_seed(0)
  busy = torch.zeros((4096, 4096), device=dev)  # for the device-only times
  rows = []

  # ---- phase 2a: K3 fused smooth stage -----------------------------------
  d = g1_states(torch, phys, mj, m, B, 0.0, gen)
  kern = k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel)
  plain = smooth_fused.plain_all(m, d)
  err3 = k3_max_err(kern, plain, s.nsite)
  worst = k3_rel_err(torch, kern, plain, s.nsite)
  tol3 = 1e-4
  print(f'K3 smooth: max abs err {err3:.3e}, max err/(1+max|plain|) '
        f'{worst:.3e} (tolerance {tol3:g})', flush=True)
  check(worst <= tol3, 'K3 disagrees with its plain version')
  ms3 = time_ms(torch, lambda: k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel),
                20)
  dev_ms3 = time_ms(
      torch, lambda: k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel), 20,
      busy=busy)
  plain_ms3 = time_ms(torch, lambda: smooth_fused.plain_all(m, d), 5)
  bytes3, flops3 = k3_work(m, d.qpos, d.qvel, kern)
  b3, by3 = bound_ms(bytes3, flops3)
  rows.append(dict(name='smooth_fused (K3)', route='cuda',
                   source='mjlab_torch/csrc/smooth.cu',
                   replaces='mjlab_tpu/ops/smooth_kernel.py:226',
                   kernel='smooth', max_abs_err=err3, ms=ms3,
                   device_ms=dev_ms3,
                   plain_ms=plain_ms3, bound_ms=b3, bound_by=by3,
                   library_ms=None))

  # K3's edge cases, each against plain_all: a batch of one, ragged batches
  # (33, and one that is no multiple of the envs a block), slide joints,
  # gravity off, a spinning root (the free joint's segment rule), a model
  # without sites, and other numbers of envs a block
  ggen = torch.Generator().manual_seed(3)
  edge3 = {}

  def k3_check(what, mv, dv, **shape):
    kern = k_smooth.smooth_fused_cuda(mv, dv.qpos, dv.qvel, **shape)
    e = k3_rel_err(torch, kern, smooth_fused.plain_all(mv, dv),
                   mv.stat.nsite)
    check(e <= tol3, f'K3 disagrees with its plain version on {what}: '
          f'{e:.3e}')
    edge3[what] = e

  for eb in (1, 33, B + 3):  # B + 3 leaves its last block of 16 short
    k3_check(f'B={eb}', m, g1_states(torch, phys, mj, m, eb, 0.0, ggen))
  spin = g1_states(torch, phys, mj, m, 33, 0.0, ggen)
  spin.qvel[:, 3:6] = torch.tensor([7.0, -4.0, 9.0], device=dev)
  k3_check('a spinning root', m, spin)
  for name, arrays in k3_variants(mj).items():
    mv = phys.put_model(arrays)
    check(smooth_fused.enabled(mv.stat), f'K3 refuses the variant {name}')
    dv = g1_states(torch, phys, arrays, mv, 33, 0.0, ggen)
    k3_check(name, mv, dv)
  shaped = g1_states(torch, phys, mj, m, 133, 0.0, ggen)
  for epb in (1, 3, 16):
    k3_check(f'{epb} envs a block', m, shaped, envs_per_block=epb)
  print('K3 edge cases (worst output err/(1+max|plain|), tolerance '
        f'{tol3:g}): ' + ', '.join(f'{k} {v:.3e}' for k, v in edge3.items()),
        flush=True)

  # ---- phase 2d: K3 with per-env constants (domain randomization) ---------
  # every segment of the float table per env, then config 5's case (only
  # body_mass, so only bconst per env), then the model variants
  pgen = torch.Generator().manual_seed(4)
  m_env = per_env_k3_model(torch, m, B, pgen)
  plan_env = k_smooth.plan_of(m_env)
  check(plan_env.dims[15] == 0b111111 and plan_env.env_batch == B,
        'not every segment of K3\'s float table is per env')
  kern_env = k_smooth.smooth_fused_cuda(m_env, d.qpos, d.qvel)
  plain_env = smooth_fused.plain_all(m_env, d)
  err3e = k3_max_err(kern_env, plain_env, s.nsite)
  worst_e = k3_rel_err(torch, kern_env, plain_env, s.nsite)
  spread = float((plain_env.qM[1:] - plain_env.qM[:1]).abs().max())
  print(f'K3 per env, every segment: max abs err {err3e:.3e}, max '
        f'err/(1+max|plain|) {worst_e:.3e} (tolerance {tol3:g}); qM spread '
        f'over envs {spread:.3e}', flush=True)
  check(worst_e <= tol3, 'K3 per env disagrees with its plain version')
  check(spread > 1e-4, 'the per-env constants did not reach qM')
  edge3e = {}

  def k3_env_check(what, mv, dv):
    kern = k_smooth.smooth_fused_cuda(mv, dv.qpos, dv.qvel)
    check(k_smooth.plan_of(mv).env_batch == dv.qpos.shape[0],
          f'K3 did not take the per-env form on {what}')
    e = k3_rel_err(torch, kern, smooth_fused.plain_all(mv, dv),
                   mv.stat.nsite)
    check(e <= tol3, f'K3 per env disagrees with its plain version on '
          f'{what}: {e:.3e}')
    edge3e[what] = e

  m_mass = per_env_k3_model(torch, m, B, pgen, fields=('body_mass',))
  check(k_smooth.plan_of(m_mass).dims[15] == 1, 'body_mass alone put more '
        'than bconst per env')
  k3_env_check('body_mass alone', m_mass, d)
  for eb in (1, 33):
    k3_env_check(f'B={eb}', per_env_k3_model(torch, m, eb, pgen),
                 g1_states(torch, phys, mj, m, eb, 0.0, ggen))
  for name, arrays in k3_variants(mj).items():
    mv = phys.put_model(arrays)
    k3_env_check(name, per_env_k3_model(torch, mv, 33, pgen),
                 g1_states(torch, phys, arrays, mv, 33, 0.0, ggen))
  print('K3 per env, edge cases (worst output err/(1+max|plain|), tolerance '
        f'{tol3:g}): ' + ', '.join(f'{k} {v:.3e}' for k, v in edge3e.items()),
        flush=True)
  # the two forms in turns on one card: shared, per env, per env, shared
  k3_env = lambda: k_smooth.smooth_fused_cuda(m_env, d.qpos, d.qvel)
  k3_mass = lambda: k_smooth.smooth_fused_cuda(m_mass, d.qpos, d.qvel)
  k3_shared = lambda: k_smooth.smooth_fused_cuda(m, d.qpos, d.qvel)
  dev_shared = [time_ms(torch, k3_shared, 20, busy=busy)]
  dev_env = time_ms(torch, k3_env, 20, busy=busy)
  dev_mass = time_ms(torch, k3_mass, 20, busy=busy)
  dev_shared.append(time_ms(torch, k3_shared, 20, busy=busy))
  ms3e = time_ms(torch, k3_env, 20)
  plain_ms3e = time_ms(torch, lambda: smooth_fused.plain_all(m_env, d), 5)
  etab_bytes = 4 * plan_env.etab.numel()
  b3e, by3e = bound_ms(*k3_work(m_env, d.qpos, d.qvel, kern_env))
  b3m, _ = bound_ms(*k3_work(m_mass, d.qpos, d.qvel, kern))
  epb_env = plan_env.fits[k_smooth.ENVS_PER_BLOCK]
  smem_env = k_smooth.smooth_smem_bytes(m_env, epb_env)
  epb_shared = k_smooth.plan_of(m).fits[k_smooth.ENVS_PER_BLOCK]
  smem_shared = k_smooth.smooth_smem_bytes(m, epb_shared)
  regs = (k_smooth.smooth_num_regs(False), k_smooth.smooth_num_regs(True))
  print(f'K3 per env, every segment: {ms3e:.4f} ms, {dev_env:.4f} ms behind '
        f'a busy card, bound {b3e:.5f} ms by {by3e} (per-env table '
        f'{etab_bytes} B); body_mass alone: {dev_mass:.4f} ms behind a busy '
        f'card, bound {b3m:.5f} ms; plain {plain_ms3e:.4f} ms; registers '
        f'{regs[1]} (shared-table form {regs[0]}); {smem_env} B of shared '
        f'memory a block of {epb_env} envs (shared-table form {smem_shared} '
        f'B, {epb_shared} envs); card {card}', flush=True)
  print(f'K3 shared table, behind a busy card, before and after the '
        f'per-env timings: {dev_shared[0]:.4f}, {dev_shared[1]:.4f} ms '
        f'(phase 2a {dev_ms3:.4f} ms; before the per-env form, PERF.md: '
        f'0.0872 ms); card {card}',
        flush=True)
  check(epb_shared == K3_G1_ENVS_PER_BLOCK,
        f'the shared-table form takes {epb_shared} envs a block')
  row_env = dict(name='smooth_fused per-env (K3)', route='cuda',
                 source='mjlab_torch/csrc/smooth.cu',
                 replaces='mjlab_tpu/ops/smooth_kernel.py:226',
                 kernel=k_smooth.NAME_PER_ENV, max_abs_err=err3e, ms=ms3e,
                 device_ms=dev_env, plain_ms=plain_ms3e, bound_ms=b3e,
                 bound_by=by3e, library_ms=None)
  del m_env, m_mass, kern_env, plain_env, plan_env

  # ---- phase 2b: K1 SPD solve on the implicitfast system -------------------
  df = pipeline.forward(m, d)
  deriv = m.dof_damping - pipeline._actuator_vel_deriv(m, df)
  H = (df.qM + dt * torch.diag_embed(deriv)).contiguous()
  g = (df.qfrc_smooth + df.qfrc_constraint).contiguous()
  x_k = k_pd.solve_pd_cuda(H, g)
  x_p = linalg.solve_pd(H, g)
  err1 = max_err(x_k, x_p)
  tol1 = 1e-4
  rel1 = err1 / scale(x_p)
  print(f'K1 pd_solve: max abs err {err1:.3e}, err/(1+max|plain|) '
        f'{rel1:.3e} (tolerance {tol1:g})', flush=True)
  check(rel1 <= tol1, 'K1 disagrees with its plain version')
  ms1 = time_ms(torch, lambda: k_pd.solve_pd_cuda(H, g), 20)
  dev_ms1 = time_ms(torch, lambda: k_pd.solve_pd_cuda(H, g), 20, busy=busy)
  plain_ms1 = time_ms(torch, lambda: linalg.solve_pd(H, g), 5)
  lib_ms1 = time_ms(torch, lambda: torch.linalg.solve(H, g[..., None]), 20)
  n = s.nv
  b1, by1 = bound_ms(*pd_solve_work(H, g))
  rows.append(dict(name='pd_solve (K1)', route='cuda',
                   source='mjlab_torch/csrc/pd_solve.cu',
                   replaces='mjlab_tpu/ops/pd_solve.py:36',
                   kernel='pd_solve', max_abs_err=err1, ms=ms1,
                   device_ms=dev_ms1,
                   plain_ms=plain_ms1, bound_ms=b1, bound_by=by1,
                   library_ms=lib_ms1))

  # K1's edge cases: any n (one lane owns one row, then two, then more),
  # a batch of one, a ragged last block
  egen = torch.Generator(device=dev).manual_seed(2)
  worst1 = 0.0
  for en in (1, 3, 18, 35, 64):
    for eb in (1, 33, B):
      A = torch.randn(eb, en, en, generator=egen, device=dev)
      He = A @ A.transpose(1, 2) + 0.5 * torch.eye(en, device=dev)
      ge = torch.randn(eb, en, generator=egen, device=dev)
      e = rel_err(k_pd.solve_pd_cuda(He, ge), linalg.solve_pd(He, ge))
      worst1 = max(worst1, e)
      check(e <= tol1, f'K1 disagrees with its plain version at n={en}, '
            f'B={eb}: {e:.3e}')
  print(f'K1 edge cases: n in (1, 3, 18, 35, 64) x B in (1, 33, {B}), worst '
        f'err/(1+max|plain|) {worst1:.3e} (tolerance {tol1:g})', flush=True)

  # ---- phase 2c: K2 Newton solve on G1 envs dropped onto the floor ---------
  args, efc = k2_dropped_input(torch, phys, mj, m, B, gen)
  rows_active = int(efc['c_active'].any(-1).sum())
  print(f'K2 input: {rows_active} of {B} envs have active contact rows, '
        f'{int(efc["c_active"].sum())} active rows in all', flush=True)
  check(rows_active > 0, 'no active contact rows in the K2 input')
  iters, polish, ldof, grad_th = solver.solver_params(s)
  kargs = dict(iterations=iters, ls_polish=polish, ldof=ldof,
               grad_th=grad_th)
  out_k = k_newton.newton_solve_cuda(*args, **kargs)
  out_p = solver.newton_plain(*args, iters, polish, ldof, grad_th)
  err2 = max_err(out_k[0], out_p[0])
  rel2 = max(max_err(a, b) / scale(b) for a, b in zip(out_k, out_p))
  tol2 = 1e-3
  print(f'K2 newton: qacc max abs err {err2:.3e}, worst output '
        f'err/(1+max|plain|) {rel2:.3e} (tolerance {tol2:g})', flush=True)
  check(rel2 <= tol2, 'K2 disagrees with its plain version')
  ms2 = time_ms(torch, lambda: k_newton.newton_solve_cuda(*args, **kargs),
                20)
  dev_ms2 = time_ms(torch, lambda: k_newton.newton_solve_cuda(*args, **kargs),
                    20, busy=busy)
  plain_ms2 = time_ms(
      torch, lambda: solver.newton_plain(*args, iters, polish, ldof,
                                         grad_th), 5)
  # the work these inputs need, per env: its active rows, and the Newton
  # steps it takes before ||grad||^2 <= grad_th^2 freezes it
  ncr = efc['c_J'].shape[1]
  need, nc, rows_b, bytes2, flops2 = newton_work(args, iters,
                                                 polish, ldof, grad_th)
  print(f'K2 work: Newton steps per env mean {float(need.double().mean()):.3f}'
        f' max {int(need.max())} of {iters}; active rows per env mean '
        f'{float(rows_b.double().mean()):.2f} (contact '
        f'{float(nc.double().mean()):.2f} of {ncr})', flush=True)
  b2, by2 = bound_ms(bytes2, flops2)
  rows.append(dict(name='newton_solve (K2)', route='cuda',
                   source='mjlab_torch/csrc/newton.cu',
                   replaces='mjlab_tpu/ops/newton.py:40',
                   kernel='newton', max_abs_err=err2, ms=ms2,
                   device_ms=dev_ms2,
                   plain_ms=plain_ms2, bound_ms=b2, bound_by=by2,
                   library_ms=None))

  # K2's edge cases, on slices of the same input: a batch of one, a ragged
  # batch, and envs whose contact rows are all inactive
  def k2_check(what, a, ldof=ldof):
    got = k_newton.newton_solve_cuda(*a, **{**kargs, 'ldof': ldof})
    want = solver.newton_plain(*a, iters, polish, ldof, grad_th)
    e = max(rel_err(g_, w_) for g_, w_ in zip(got, want))
    check(all(bool(torch.isfinite(g_).all()) for g_ in got),
          f'K2 gave non-finite output on {what}')
    check(e <= tol2, f'K2 disagrees with its plain version on {what}: '
          f'{e:.3e}')
    return e

  e_one = k2_check('a batch of 1', [t[:1].contiguous() for t in args])
  e_rag = k2_check('a batch of 33', [t[5:38].contiguous() for t in args])
  nocon = [t[:64].clone() for t in args]
  nocon[6][::3] = False  # c_active
  nocon[5][::3] = 0.0  # c_D is zero on inactive rows, as make_efc leaves it
  e_noc = k2_check('a batch with contact-free envs', nocon)
  n_free = int((~nocon[6].any(-1)).sum())
  check(n_free > 0, 'no contact-free env in the K2 edge case')
  print(f'K2 edge cases: B=1 {e_one:.3e}, B=33 {e_rag:.3e}, {n_free} of 64 '
        f'envs without active contact rows {e_noc:.3e} (worst output '
        f'err/(1+max|plain|), tolerance {tol2:g})', flush=True)

  # K2 where one lane of the factorization owns more than two rows of the
  # Hessian (n + 1 > 64; no model of the repo is that wide): random
  # problems at n = 64 and a ragged n = 70
  wide = {}
  for en in (64, 70):
    wargs, wldof = random_newton_args(torch, 33, en, 48, 20, egen)
    check(k_newton.fits(en, 48, 20), f'K2 refuses n={en}')
    wide[en] = k2_check(f'a random problem at n={en}', wargs, wldof)
  print(f'K2 edge cases, many rows a lane: n=64 {wide[64]:.3e}, n=70 '
        f'{wide[70]:.3e} (33 random problems each, 48 contact and 20 limit '
        f'rows; worst output err/(1+max|plain|), tolerance {tol2:g})',
        flush=True)

  def k2_cap_check(what, a, need):
    """K2 with a cap of `iters` against a cap of 3 * iters. An env the
    plain solver finds frozen within the cap can no longer move; both runs
    stop within grad_th of its minimizer, so they agree to 1e-5 (the
    kernel's own float32 gradient may cross the threshold one step away
    from the plain solver's)."""
    frozen = need < iters
    nf = int(frozen.sum())
    if nf == 0:
      print(f'K2 iteration cap on {what}: no env freezes within {iters} '
            f'steps', flush=True)
      return 0
    short = k_newton.newton_solve_cuda(*a, **kargs)
    full = k_newton.newton_solve_cuda(*a, **{**kargs, 'iterations': 3 * iters})
    e = max(rel_err(s_[frozen], f_[frozen]) for s_, f_ in zip(short, full))
    same = int(torch.stack([(s_[frozen] == f_[frozen]).all(-1)
                            for s_, f_ in zip(short, full)]).all(0).sum())
    print(f'K2 iteration cap on {what}: {nf} of {frozen.numel()} envs frozen '
          f'within {iters} steps; cap {iters} vs {3 * iters} on them: worst '
          f'err/(1+max) {e:.3e} (tolerance 1e-05), {same} bit-identical',
          flush=True)
    check(e <= 1e-5, f'K2 depends on its iteration cap on {what}')
    return nf

  capped = k2_cap_check('the phase-2c input', args, need)

  stamp('phase 2')

  # ---- phase 2e: K1-K3 at the Go1's shapes ---------------------------------
  go1 = go1_kernels(torch, card, busy)

  stamp('phase 2e')

  # ---- phase 2f: K4 contact rows at the training cell's 16384 envs ---------
  rows.append(k4_numbers(torch, phys, mj, card, busy))

  stamp('phase 2f')

  # ---- phase 3: the main path --------------------------------------------
  gen.manual_seed(1)
  d = phys.make_batched_data(m, B)
  key = torch.as_tensor(mj.key_qpos[0], dtype=torch.float32)
  qpos = key.expand(B, -1).clone()
  qpos[:, 7:] += 0.02 * torch.randn(B, s.nq - 7, generator=gen)
  ctrl = torch.as_tensor(mj.key_ctrl[0], dtype=torch.float32).expand(B, -1)
  d = d.replace(qpos=qpos.to(dev), ctrl=ctrl.to(dev).clone())
  torch.cuda.synchronize()
  reset_launches()
  t0 = time.perf_counter()
  for _ in range(SUBSTEPS):
    d = phys.step(m, d)
  torch.cuda.synchronize()
  wall = time.perf_counter() - t0
  launches = dict(LAUNCHES)
  print(f'main path launches: {launches}', flush=True)
  for r in rows:
    r['launches'] = int(launches.get(r.pop('kernel'), 0))
    check(r['launches'] > 0, f'{r["name"]} was not launched on the main path')
  finite = all(bool(torch.isfinite(t).all()) for t in (
      d.qpos, d.qvel, d.qacc, d.efc_force, d.sensordata))
  check(finite, 'non-finite state after the main path')
  z = d.qpos[:, 2]
  upright = float(((z > 0.3) & (z < 1.0)).float().mean())
  feet = float((d.sensordata > 0).all(-1).float().mean())
  print(f'pelvis height: min {float(z.min()):.4f} max {float(z.max()):.4f} '
        f'm, in [0.3, 1.0] m for {upright:.4f} of envs; both foot contact '
        f'sensors found for {feet:.4f} of envs', flush=True)
  check(upright >= 0.95, 'pelvis height out of band in over 5% of envs')
  check(feet >= 0.5, 'foot contacts found in under half of the envs')
  print(f'physics only, not comparable to bench.py env-steps: {SUBSTEPS} '
        f'substeps x {B} envs in {wall:.3f} s = '
        f'{SUBSTEPS * B / wall:.1f} env-substeps/s = '
        f'{SUBSTEPS * B / wall / 4:.1f} physics env-steps/s (4 substeps '
        f'each), {SUBSTEPS / wall:.1f} substeps/s; card {card}', flush=True)

  # ---- phase 3b: where a main-path substep's time goes --------------------
  substep_stages(torch, m, d, card, 'main path')

  # ---- phase 3c: K2 alone on the state the main path settled into ---------
  ds = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  ds = smooth.fwd_smooth(m, smooth.actuation(m, ds))
  sargs = solver.newton_args(ds, constraint.make_efc(m, ds))
  s_need, s_nc, s_rows, s_bytes, s_flops = newton_work(
      sargs, iters, polish, ldof, grad_th)
  s_out = k_newton.newton_solve_cuda(*sargs, **kargs)
  s_ref = solver.newton_plain(*sargs, iters, polish, ldof, grad_th)
  s_rel = max(rel_err(a, b) for a, b in zip(s_out, s_ref))
  check(s_rel <= tol2, 'K2 disagrees with its plain version on the settled '
        f'state: {s_rel:.3e}')
  s_ms = time_ms(torch, lambda: k_newton.newton_solve_cuda(*sargs, **kargs),
                 20)
  s_dev_ms = time_ms(
      torch, lambda: k_newton.newton_solve_cuda(*sargs, **kargs), 20,
      busy=busy)
  s_bound, s_by = bound_ms(s_bytes, s_flops)
  print(f'K2 on the settled main-path state: Newton steps per env mean '
        f'{float(s_need.double().mean()):.3f} max {int(s_need.max())} of '
        f'{iters}; active rows per env mean '
        f'{float(s_rows.double().mean()):.2f} (contact '
        f'{float(s_nc.double().mean()):.2f} of {ncr}); {s_ms:.4f} ms ({s_dev_ms:.4f} ms behind a busy card), bound '
        f'{s_bound:.5f} ms by {s_by}; worst output err/(1+max|plain|) '
        f'{s_rel:.3e} (tolerance {tol2:g}); card {card}', flush=True)
  capped += k2_cap_check('the settled main-path state', sargs, s_need)
  check(capped > 0, 'no frozen env to hold the iteration cap against')

  # ---- phase 4: small rollout, CUDA float32 vs the CPU float64 plain path --
  nsmall, steps = 8, 10
  mc = phys.put_model(mj, device='cpu', dtype=torch.float64)
  dc = phys.make_batched_data(mc, nsmall, device='cpu')
  dc = dc.replace(qpos=qpos[:nsmall].double(),
                  ctrl=ctrl[:nsmall].double().clone())
  dg = phys.make_batched_data(m, nsmall)
  dg = dg.replace(qpos=qpos[:nsmall].to(dev), ctrl=ctrl[:nsmall].to(dev))
  for _ in range(steps):
    dc = phys.step(mc, dc)
    dg = phys.step(m, dg)
  err4 = max_err(dg.qpos.cpu(), dc.qpos)
  tol4 = 1e-4
  print(f'{steps}-substep rollout, {nsmall} envs: CUDA f32 vs CPU f64 '
        f'plain qpos max abs err {err4:.3e} (tolerance {tol4:g})',
        flush=True)
  check(err4 <= tol4, 'CUDA rollout disagrees with the CPU reference')

  stamp('phases 3-4')

  # ---- phase 5: the environment path ----------------------------------------
  env_launches = env_path(torch, card)
  kernel_of = {'smooth_fused (K3)': 'smooth', 'pd_solve (K1)': 'pd_solve',
               'newton_solve (K2)': 'newton',
               'contact_rows (K4)': 'contact_rows'}
  for r in rows:
    r['env_path_launches'] = int(env_launches.get(kernel_of[r['name']], 0))
    check(r['env_path_launches'] > 0,
          f'{r["name"]} was not launched on the env path')

  stamp('phase 5')

  # ---- phase 6: the training path ------------------------------------------
  import atexit
  import shutil
  import tempfile
  keep = {'dir': tempfile.mkdtemp(prefix='chip_smoke_keep_')}
  atexit.register(shutil.rmtree, keep['dir'], True)
  train_launches = train_path(torch, card, keep)
  for r in rows:
    r['train_path_launches'] = int(train_launches.get(kernel_of[r['name']],
                                                      0))
    check(r['train_path_launches'] > 0,
          f'{r["name"]} was not launched on the training path')

  stamp('phase 6')

  # ---- phase 7: config 5, every K3 launch in its per-env form ---------------
  c5_launches = config5_path(torch, card)
  for r in rows:
    r['config5_path_launches'] = int(c5_launches.get(kernel_of[r['name']],
                                                     0))
  row_env['launches'] = int(c5_launches.get(row_env.pop('kernel'), 0))
  row_env['config5_path_launches'] = row_env['launches']
  check(row_env['launches'] > 0 and all(
      r['config5_path_launches'] > 0 for r in rows[1:]),
        'a kernel of the config-5 path was not launched on it')
  rows.append(row_env)

  stamp('phase 7')

  # ---- phase 8: the Go1 flat task: env-steps, the demo, card vs CPU ---------
  go1_launches = go1_path(torch, card)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['go1_path_launches'] = int(go1_launches.get(kern, 0))
    if kern == 'contact_rows':
      check(r['go1_path_launches'] == 0, 'K4 was launched on the Go1 path')
    if kern in go1:
      r['go1'] = go1[kern]
      check(r['go1_path_launches'] > 0,
            f'{r["name"]} was not launched on the Go1 path')

  stamp('phase 8')

  # ---- phase 9: G1 motion tracking: env, training, shipped policy -----------
  track_launches, row_env['tracking'] = tracking_path(torch, card, busy)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['tracking_path_launches'] = int(track_launches.get(kern, 0))
    check((r['tracking_path_launches'] > 0) == (kern != 'smooth'),
          f'{r["name"]} was launched {r["tracking_path_launches"]} times on '
          'the tracking path')

  stamp('phase 9')

  # ---- phase 10: rough terrain, the G1 and the Go1 ---------------------------
  rough_launches, rough_k2 = rough_path(torch, card, busy)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['rough_path_launches'] = int(rough_launches.get(kern, 0))
    check((r['rough_path_launches'] > 0) == (kern != 'smooth_env'),
          f'{r["name"]} was launched {r["rough_path_launches"]} times on '
          'the rough path')
    if kern == 'newton':
      r['rough_go1'] = rough_k2

  stamp('phase 10')

  # ---- phase 11: the NaN guard and the blowup ring on G1 flat training -------
  nan_launches = nan_path(torch, card)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['nan_path_launches'] = int(nan_launches.get(kern, 0))
    check((r['nan_path_launches'] > 0) == (kern != 'smooth_env'),
          f'{r["name"]} was launched {r["nan_path_launches"]} times on the '
          'nan path')

  stamp('phase 11')

  # ---- phase 12: the Tiny tasks and the elliptic cone -------------------------
  # 12a: K1-K3 at the TinyBot's shapes; K1 on the elliptic G1's Hessians
  tiny = tiny_kernels(torch, card, busy)
  ell_k1 = elliptic_hessians(torch, card, busy)
  # 12b: the three Tiny tasks at 4096 envs, env-steps and training
  tiny_launches = tiny_path(torch, card)
  # 12c: G1 flat with cone='elliptic' at 4096 envs, env-steps and training
  ell_launches = elliptic_path(torch, card)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['tiny_path_launches'] = int(tiny_launches.get(kern, 0))
    r['elliptic_path_launches'] = int(ell_launches.get(kern, 0))
    if kern in tiny:
      r['tiny'] = tiny[kern]
    if kern == 'pd_solve':
      r['elliptic_hessians'] = ell_k1
    check((r['tiny_path_launches'] > 0) == (kern != 'contact_rows'),
          f'{r["name"]} was launched {r["tiny_path_launches"]} times on the '
          'Tiny path')
    check((r['elliptic_path_launches'] > 0) == (kern in ('smooth',
                                                         'pd_solve')),
          f'{r["name"]} was launched {r["elliptic_path_launches"]} times on '
          'the elliptic path')

  stamp('phase 12')

  # ---- phase 13: multi-GPU training, scripts.train --shard -----------------
  shard_launches = shard_path(torch, card)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['shard_path_launches'] = int(shard_launches.get(kern, 0))
    check((r['shard_path_launches'] > 0) == (kern != 'smooth_env'),
          f'{r["name"]} was launched {r["shard_path_launches"]} times on '
          'the shard path')

  stamp('phase 13')

  # ---- phase 14: equality constraints, tendons, mocap bodies, sensors ------
  oracle_launches, oracle_k = oracle_path(torch, card, busy)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['oracle_path_launches'] = int(oracle_launches.get(kern, 0))
    r.update(oracle_k.get(kern, {}))
    check((r['oracle_path_launches'] > 0) == (kern not in ('smooth_env',
                                                           'contact_rows')),
          f'{r["name"]} was launched {r["oracle_path_launches"]} times on '
          'the oracle path')

  stamp('phase 14')

  # ---- phase 15: the convex pile, every collider of the convex solids ------
  pile_launches, pile_rows = pile_path(torch, card, busy)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['pile_path_launches'] = int(pile_launches.get(kern, 0))
    check((r['pile_path_launches'] > 0) == (kern not in ('smooth_env',
                                                         'contact_rows')),
          f'{r["name"]} was launched {r["pile_path_launches"]} times on '
          'the pile path')

  stamp('phase 15')

  # ---- phase 16: the spec path's model: the round-4 ring, the route rule ---
  t16 = time.perf_counter()
  ring_launches, ring_k = ring_path(torch, card, busy)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['replay_path_launches'] = int(ring_launches.get(kern, 0))
    check((r['replay_path_launches'] > 0) == (kern != 'smooth_env'),
          f'{r["name"]} was launched {r["replay_path_launches"]} times on '
          'the replay path')
    if kern in ring_k:
      r['ring'] = ring_k[kern]
  route_path(torch)
  step = step_time(torch, card)
  print(f'K3 on the 69-geom G1: {rows[0]["ms"]:.4f} ms, '
        f'{rows[0]["device_ms"]:.4f} ms behind a busy card (on 34 geoms '
        f'0.1661, 0.0873 ms, PERF.md section 6); env-step median '
        f'{step["median_ms"]:.3f} ms; phase 16 '
        f'{time.perf_counter() - t16:.1f} s; card {card}', flush=True)

  stamp('phase 16')

  # ---- phase 17: training videos, play --render, the memory guard ----------
  video_launches, render_launches = video_path(torch, card, keep)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['video_path_launches'] = int(video_launches.get(kern, 0))
    r['render_path_launches'] = int(render_launches.get(kern, 0))
    for key in ('video_path_launches', 'render_path_launches'):
      check((r[key] > 0) == (kern != 'smooth_env'),
            f'{r["name"]} was launched {r[key]} times on the '
            f'{key.split("_")[0]} path')

  stamp('phase 17')

  # ---- phase 18: the profile CLI, stages, roofline and trace ---------------
  prof_launches = profile_path(torch, card)
  for r in rows:
    kern = kernel_of.get(r['name'], 'smooth_env')
    r['profile_path_launches'] = int(prof_launches.get(kern, 0))
    check((r['profile_path_launches'] > 0) == (kern != 'smooth_env'),
          f'{r["name"]} was launched {r["profile_path_launches"]} times on '
          'the profile path')

  stamp('phase 18')

  # ---- phase 19: G1 flat under random torso wrenches ------------------------
  wrench_launches = wrench_path(torch, card, busy)
  for r in rows + pile_rows:
    kern = kernel_of.get(r['name']) or next(
        (k for k, v in KERNEL_ROWS.items() if r['name'].startswith(v[0])),
        'smooth_env')
    r['wrench_path_launches'] = int(wrench_launches.get(kern, 0))
    check((r['wrench_path_launches'] > 0) == (kern != 'smooth_env'),
          f'{r["name"]} was launched {r["wrench_path_launches"]} times on '
          'the wrench path')

  stamp('phase 19')
  for r in rows:
    print(f'{r["name"]}: {r["ms"]:.4f} ms, {r["device_ms"]:.4f} ms behind a '
          f'busy card (plain {r["plain_ms"]:.4f} ms, '
          f'bound {r["bound_ms"]:.5f} ms by {r["bound_by"]}), launches on '
          f'the physics path {r.get("launches") if r is not row_env else 0},'
          f' the env path {r.get("env_path_launches", 0)}, the training path '
          f'{r.get("train_path_launches", 0)}, the config-5 path '
          f'{r["config5_path_launches"]}, the Go1 path '
          f'{r["go1_path_launches"]}, the tracking path '
          f'{r["tracking_path_launches"]}, the rough path '
          f'{r["rough_path_launches"]}, the nan path '
          f'{r["nan_path_launches"]}, the Tiny path '
          f'{r["tiny_path_launches"]}, the elliptic path '
          f'{r["elliptic_path_launches"]}, the shard path '
          f'{r["shard_path_launches"]}, the oracle path '
          f'{r["oracle_path_launches"]}, the pile path '
          f'{r["pile_path_launches"]}, the replay path '
          f'{r["replay_path_launches"]}, the video path '
          f'{r["video_path_launches"]}, the render path '
          f'{r["render_path_launches"]}, the profile path '
          f'{r["profile_path_launches"]}, the wrench path '
          f'{r["wrench_path_launches"]}; card {card}', flush=True)
  for r in pile_rows:
    print(f'{r["name"]}: {r["ms"]:.4f} ms, {r["device_ms"]:.4f} ms behind a '
          f'busy card (plain {r["plain_ms"]:.4f} ms, bound '
          f'{r["bound_ms"]:.5f} ms by {r["bound_by"]}), launches on the pile '
          f'path {r["launches"]}, the wrench path '
          f'{r["wrench_path_launches"]}; card {card}', flush=True)
  rows.extend(pile_rows)
  print(json.dumps({'kernels': rows}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
  if sys.argv[1:2] == ['--shard-rank']:  # a rank of phase 13b
    shard_rank(sys.argv[2:])
  else:
    main()
