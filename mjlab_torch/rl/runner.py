"""On-policy training runner: learn loop, logging, checkpoint and resume.

Counterpart of mjlab_tpu/rl/runner.py. Checkpoints are `model_{iteration}.pt`
files of plain tensors and dicts (`torch.save`, read back with
`torch.load(weights_only=True)`): parameters, Adam state, both normalizers,
the learning rate, the learner's generator, the iteration and, with
`full_state`, the env's state (through envs/io.py), its observations and
its generator.

With `cfg.video` the rollout records env 0's qpos on the device; the runner
keeps the last ceil(video_length / num_steps_per_env) rollouts' records (a
device copy each, no host read) and, every `video_interval` iterations,
copies them to the host once and draws the last `video_length` frames into
`<log_dir>/videos/train/rl-video-iter-{it}.mp4` (viewer/offscreen.py). A
failed render is printed and training goes on.

Sharded (the env's `world`, parallel/sharding.py): every rank runs the same
learn loop, and so the same collectives on the same iterations; only rank 0
prints, writes `metrics.jsonl` and the writers, saves and exports. A
checkpoint holds the global env axis, gathered from the ranks, so that it is
laid out as an unsharded run's and resumes at any world size; `load` gives
each rank its rows and every rank rank 0's learner.
"""

from __future__ import annotations

import collections
import os
import re
import time

import numpy as np
import torch

from mjlab_torch.parallel.sharding import (
    broadcast_object,
    gather_env,
    shard_batched,
)
from mjlab_torch.physics.io import resolve_device
from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg
from mjlab_torch.rl.ppo import PPO, AdamState, TrainState, broadcast_learner


def _cpu(tree):
  """Tensors and numpy arrays of a nested dict as CPU tensors."""
  if isinstance(tree, dict):
    return {k: _cpu(v) for k, v in tree.items()}
  if isinstance(tree, np.ndarray):
    return torch.from_numpy(tree)
  return tree.detach().cpu() if torch.is_tensor(tree) else tree


def _numpy(tree):
  if isinstance(tree, dict):
    return {k: _numpy(v) for k, v in tree.items()}
  return tree.numpy() if torch.is_tensor(tree) else tree


def _copy_(dst: 'dict[str, torch.Tensor]', src: dict) -> None:
  with torch.no_grad():
    for k, t in dst.items():
      t.copy_(src[k])


class OnPolicyRunner:
  """PPO on `env` under `cfg`; `cfg.device` must be the env's device ('cuda'
  by default: asking for it on a host without a GPU raises)."""

  def __init__(self, env, cfg: RslRlOnPolicyRunnerCfg,
               log_dir: 'str | None' = None, step_fn=None):
    dev = resolve_device(cfg.device)
    if torch.device(env.device).type != dev.type:
      raise ValueError(f'the runner is asked for {cfg.device!r} but the env '
                       f'lives on {env.device}')
    self.env = env
    self.cfg = cfg
    self.alg = PPO(env, cfg, step_fn=step_fn)
    self.world = self.alg.world
    self.ts: TrainState = self.alg.init_state(cfg.seed)
    broadcast_learner(self.ts, self.world)
    self.log_dir = log_dir
    self._writers = []
    self._video_buf = None
    if log_dir and self.world.is_main:
      os.makedirs(log_dir, exist_ok=True)
      if cfg.logger != 'none':
        from mjlab_torch.rl.writers import make_writers
        self._writers = make_writers(
            cfg.logger, log_dir, project=cfg.experiment_name,
            run_name=cfg.run_name or None)
      if cfg.video:
        keep = max(1, -(-cfg.video_length // cfg.num_steps_per_env))
        self._video_buf = collections.deque(maxlen=keep)

  def learn(self, num_iterations: 'int | None' = None,
            log_every: int = 10) -> dict:
    n_iter = num_iterations or self.cfg.max_iterations
    # env-steps of every rank's envs
    steps_per_iter = self.cfg.num_steps_per_env * self.world.num_envs
    last_logs = {}
    t_start = time.time()
    # throughput over the whole logging window: the host runs ahead of the
    # device, so one iteration's wall time says little
    t_win, it_win = time.time(), 0
    for it in range(n_iter):
      self.ts, logs = self.alg.learn_iteration(self.ts)
      clock = logs.pop('_clock')
      qpos_env0 = logs.pop('_qpos_env0', None)
      if self._video_buf is not None:
        # a device copy: the next rollout writes the same buffer
        self._video_buf.append(qpos_env0.clone())
        if (it + 1) % self.cfg.video_interval == 0:
          self._emit_video(it + 1)
      if it % log_every == 0 or it == n_iter - 1:
        # one read of the device for all the iteration's logs
        keys = list(logs)
        values = torch.stack([logs[k].float() for k in keys]).tolist()
        logs = dict(zip(keys, values))
        logs.update(clock.ms())
        now = time.time()
        dt, n_win = now - t_win, it + 1 - it_win
        t_win, it_win = now, it + 1
        logs['iteration'] = self.ts.iteration
        logs['env_steps_per_s'] = n_win * steps_per_iter / max(dt, 1e-9)
        logs['total_env_steps'] = logs['iteration'] * steps_per_iter
        logs['wall_s'] = time.time() - t_start
        last_logs = logs
        self._write_log(logs)
        # the env's blowup ring (MJLAB_BLOWUP_DUMP), fetched here, once a
        # logged iteration, so that the steps read nothing more
        dump = getattr(self.env, 'maybe_dump_forensics', None)
        if dump is not None:
          dump(self.ts.env_state)
      if self.log_dir and self.cfg.save_interval and \
          (it + 1) % self.cfg.save_interval == 0:
        # named by the training iteration, which a resumed run continues
        self.save(self._ckpt_path())
    if self.log_dir:
      self.save(self._ckpt_path())
    return last_logs

  def _ckpt_path(self) -> str:
    return os.path.join(self.log_dir, f'model_{self.ts.iteration}.pt')

  def _write_log(self, logs: dict):
    if not self.world.is_main:
      return
    msg = (f"it {logs.get('iteration', 0):6d} | "
           f"rew/s {logs.get('mean_reward', 0):8.3f} | "
           f"ep_rew {logs.get('mean_episode_reward', 0):8.2f} | "
           f"ep_len {logs.get('mean_episode_length', 0):7.1f} | "
           f"kl {logs.get('kl', 0):.4f} | lr {logs.get('lr', 0):.1e} | "
           f"collect {logs.get('collection_ms', 0):.0f} ms | "
           f"learn {logs.get('learning_ms', 0):.0f} ms | "
           f"steps/s {logs.get('env_steps_per_s', 0):,.0f}")
    print(msg, flush=True)
    for w in self._writers:
      w.log(logs, logs.get('iteration', 0))

  def _emit_video(self, iteration: int):
    """Draw the buffered window of env 0's qpos, its last video_length
    frames, into the run's videos/train."""
    from mjlab_torch.viewer.offscreen import render_trajectory
    # one copy to the host for the whole window
    qpos = torch.cat(list(self._video_buf)).cpu().numpy()
    qpos = qpos[-self.cfg.video_length:]
    vdir = os.path.join(self.log_dir, 'videos', 'train')
    os.makedirs(vdir, exist_ok=True)
    path = os.path.join(vdir, f'rl-video-iter-{iteration}.mp4')
    try:
      out = render_trajectory(self.env, qpos, path)
      print(f'[video] wrote {out}', flush=True)
    except Exception as e:  # a render never stops training
      print(f'[video] rendering failed: {e!r}', flush=True)

  def close(self):
    for w in self._writers:
      w.close()

  # ------------------------------------------------------------------
  def save(self, path: str, full_state: bool = True):
    """Write the learner (and with `full_state` the env's state, of every
    rank's envs) to `path`. Every rank calls it; rank 0 writes."""
    ts = self.ts
    payload = {
        'params': _cpu(dict(ts.net.named_parameters())),
        'adam': _cpu({'count': ts.adam.count, 'mu': ts.adam.mu,
                      'nu': ts.adam.nu}),
        'actor_norm': _cpu(dict(ts.actor_norm.named_buffers())),
        'critic_norm': _cpu(dict(ts.critic_norm.named_buffers())),
        'lr': _cpu(ts.lr),
        # a generator's state is that of its device type's generator
        'device': self.alg.device.type,
        'gen': ts.gen.get_state(),
        'iteration': ts.iteration,
    }
    if full_state:
      # env_state_to_numpy leaves out the forensic ring: a checkpoint is
      # the same with the ring on or off
      from mjlab_torch.envs.io import env_state_to_numpy
      payload['env_state'] = _cpu(gather_env(
          env_state_to_numpy(ts.env_state, self.env), self.world,
          replicated_paths=self.env.replicated_state))
      payload['obs'] = _cpu(gather_env(ts.obs, self.world))
      # the ranks' generators are in lockstep: rank 0's is every rank's
      payload['env_gen'] = self.env.generator.get_state()
    if self.world.is_main:
      torch.save(payload, path)

  def load(self, path: str, load_env_state: bool = False) -> dict:
    """Restore the learner from `path`; the env's state (and generator)
    only on request and only if the checkpoint holds it. Generators are
    restored only from a checkpoint written on the same device type (a
    CUDA generator's state is no CPU generator's). Sharded, rank 0 alone
    reads the learner and sends it to the others, which need not see the
    file; with `load_env_state` every rank reads the file and takes its
    rows of the checkpoint's envs, whose count must be the world's. Every
    rank then holds rank 0's learner. Returns the checkpoint's payload
    (sharded and without `load_env_state`, its learner's part)."""
    world = self.world
    if world.sharded and not load_env_state:
      payload = None
      if world.is_main:
        payload = {k: v for k, v in torch.load(
            path, map_location='cpu', weights_only=True).items()
                   if k not in ('env_state', 'obs', 'env_gen')}
      payload = broadcast_object(payload, world)
    else:
      payload = torch.load(path, map_location='cpu', weights_only=True)
    ts = self.ts
    _copy_(dict(ts.net.named_parameters()), payload['params'])
    adam = payload['adam']
    ts.adam = AdamState(
        count=adam['count'].to(self.alg.device),
        mu={k: v.to(self.alg.device) for k, v in adam['mu'].items()},
        nu={k: v.to(self.alg.device) for k, v in adam['nu'].items()})
    _copy_(dict(ts.actor_norm.named_buffers()), payload['actor_norm'])
    _copy_(dict(ts.critic_norm.named_buffers()), payload['critic_norm'])
    ts.lr = payload['lr'].to(self.alg.device)
    same_device = payload['device'] == self.alg.device.type
    if same_device:
      ts.gen.set_state(payload['gen'])
    ts.iteration = int(payload['iteration'])
    if load_env_state and 'env_state' in payload:
      from mjlab_torch.envs.io import env_state_from_numpy
      n_ckpt = {v.shape[0] for v in payload['obs'].values()}
      if n_ckpt != {world.num_envs}:
        raise ValueError(f'the checkpoint holds {n_ckpt} envs, the world '
                         f'{world.num_envs}')
      ts.env_state = env_state_from_numpy(
          shard_batched(_numpy(payload['env_state']), world,
                        replicated_paths=self.env.replicated_state),
          self.env)
      ts.obs = {k: v.to(self.alg.device)
                for k, v in shard_batched(payload['obs'], world).items()}
      if same_device:
        self.env.generator.set_state(payload['env_gen'])
    broadcast_learner(ts, self.world)
    return payload

  def get_inference_policy(self):
    return self.alg.policy_fn(self.ts)


class VelocityOnPolicyRunner(OnPolicyRunner):
  """The velocity task's runner: every checkpoint save also writes the
  policy's deployment ONNX beside it (`model_{it}.onnx` and its
  `.meta.json`, rl/exporter.py). As in the reference, a failed export is
  printed and training goes on; the checkpoint is written first."""

  def save(self, path: str, full_state: bool = True):
    super().save(path, full_state)
    if not self.world.is_main:
      return
    try:
      from mjlab_torch.rl.exporter import export_policy_as_onnx
      pol = self.cfg.policy
      export_policy_as_onnx(
          self.ts.net, self.ts.actor_norm, self.env,
          os.path.splitext(path)[0] + '.onnx',
          normalize_obs=pol.actor_obs_normalization,
          activation=pol.activation)
    except Exception as e:  # an export never stops training
      print(f'[export] onnx export failed: {e!r}', flush=True)


def _motion(env):
  """The motion clip of the env's motion command term, or None."""
  cm = getattr(env, 'command_manager', None)
  for term in (cm.terms.values() if cm is not None else ()):
    if getattr(term, 'motion', None) is not None:
      return term.motion
  return None


class MotionTrackingOnPolicyRunner(OnPolicyRunner):
  """The tracking task's runner: every checkpoint save also writes the
  policy's deployment ONNX with the env's motion clip baked in
  (`export_motion_policy_as_onnx`). A failed export is printed and
  training goes on, as in the velocity runner."""

  def save(self, path: str, full_state: bool = True):
    super().save(path, full_state)
    if not self.world.is_main:
      return
    try:
      from mjlab_torch.rl.exporter import export_motion_policy_as_onnx
      motion = _motion(self.env)
      if motion is None:
        raise RuntimeError('no motion command term found')
      pol = self.cfg.policy
      export_motion_policy_as_onnx(
          self.ts.net, self.ts.actor_norm, self.env, motion,
          os.path.splitext(path)[0] + '.onnx',
          normalize_obs=pol.actor_obs_normalization,
          activation=pol.activation)
    except Exception as e:  # an export never stops training
      print(f'[export] onnx export failed: {e!r}', flush=True)


def make_runner(env, cfg, log_dir=None, step_fn=None) -> OnPolicyRunner:
  """The task's runner: the tracking runner for an env whose command term
  has a motion, else the velocity runner."""
  cls = (MotionTrackingOnPolicyRunner if _motion(env) is not None
         else VelocityOnPolicyRunner)
  return cls(env, cfg, log_dir=log_dir, step_fn=step_fn)


def get_checkpoint_path(log_root: str, run_regex: str = '.*',
                        ckpt_regex: str = r'model_.*\.pt') -> str:
  """The newest matching checkpoint of the newest matching run."""
  runs = sorted(
      (d for d in os.listdir(log_root)
       if re.fullmatch(run_regex, d)
       and os.path.isdir(os.path.join(log_root, d))),
      key=lambda d: os.path.getmtime(os.path.join(log_root, d)))
  if not runs:
    raise FileNotFoundError(f'no runs matching {run_regex} in {log_root}')
  run_dir = os.path.join(log_root, runs[-1])
  ckpts = sorted(
      (f for f in os.listdir(run_dir) if re.fullmatch(ckpt_regex, f)),
      key=lambda f: os.path.getmtime(os.path.join(run_dir, f)))
  if not ckpts:
    raise FileNotFoundError(f'no checkpoints in {run_dir}')
  return os.path.join(run_dir, ckpts[-1])
