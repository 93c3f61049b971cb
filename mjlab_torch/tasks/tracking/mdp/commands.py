"""Motion-tracking command: reference-motion playback with adaptive start
sampling and reference state initialization (RSI).

Counterpart of mjlab_tpu/tasks/tracking/mdp/commands.py: per-env time
indices into a motion clip, an EMA of per-bin failure counts smoothed with
a decaying kernel driving a multinomial draw of start bins, anchor-body
yaw-only alignment of the relative body targets, and RSI pose, velocity
and joint randomization on reset (the event `reset_to_motion`). The motion
arrays ride in the command state as `motion/*` leaves, as in the JAX
package, so checkpoints and state carry-over see the same leaves.

Every draw is made for every env and kept by `torch.where`, as the JAX
package does: indexing by a mask would read the mask on the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mjlab_torch.envs.mdp.events import _sample_axes
from mjlab_torch.managers.command_manager import CommandTerm
from mjlab_torch.managers.term_cfg import CommandTermCfg
from mjlab_torch.physics.tables import ix, table
from mjlab_torch.utils import math as tmath
from mjlab_torch.utils.string import resolve_matching_names

_MOTION = ('joint_pos', 'joint_vel', 'body_pos_w', 'body_quat_w',
           'body_lin_vel_w', 'body_ang_vel_w')


class MotionLoader:
  """The npz motion clip: joint_pos / joint_vel (T, nj) and body_pos_w /
  body_quat_w / body_lin_vel_w / body_ang_vel_w (T, nbody, ...), the body
  axis cut to `body_indexes` (entity-local ids), float32."""

  def __init__(self, motion_file: str, body_indexes: np.ndarray):
    with np.load(motion_file) as data:
      for k in _MOTION:
        a = np.asarray(data[k], np.float32)
        setattr(self, k, a if k.startswith('joint') else a[:, body_indexes])
    self.time_step_total = self.joint_pos.shape[0]


@dataclasses.dataclass
class MotionCommandCfg(CommandTermCfg):
  motion_file: str = ''
  anchor_body_name: str = ''
  body_names: tuple = ()
  asset_name: str = 'robot'
  pose_range: dict = dataclasses.field(default_factory=dict)
  velocity_range: dict = dataclasses.field(default_factory=dict)
  joint_position_range: tuple = (-0.52, 0.52)
  adaptive_kernel_size: int = 1
  adaptive_lambda: float = 0.8
  adaptive_uniform_ratio: float = 0.1
  adaptive_alpha: float = 0.001
  disable_adaptive_sampling: bool = False

  def __post_init__(self):
    if self.class_type is None:
      self.class_type = MotionCommand


class MotionCommand(CommandTerm):

  # the clip, and the bin failures every rank reduces over the ranks
  replicated_state = ('bin_failed', 'current_bin_failed', 'motion/')

  def __init__(self, cfg: MotionCommandCfg, scene, num_envs: int):
    super().__init__(cfg, scene, num_envs)
    self.view = view = scene[cfg.asset_name]
    names = list(cfg.body_names)
    self.robot_anchor_idx = list(view.idx.body_names).index(
        cfg.anchor_body_name)
    self.motion_anchor_idx = names.index(cfg.anchor_body_name)
    ids, _ = resolve_matching_names(names, view.idx.body_names,
                                    preserve_order=True)
    self.body_indexes = np.asarray(ids, np.int32)  # entity-local body ids
    # the clip's body axis is the entity's body order
    self.motion = MotionLoader(cfg.motion_file, self.body_indexes)
    self.n_bodies = len(names)
    T = self.motion.time_step_total
    self.n_bins = int(T // 50) + 1  # ~1 bin/s at 50 Hz control
    lam, k = cfg.adaptive_lambda, cfg.adaptive_kernel_size
    kern = np.asarray([lam ** i for i in range(k)], np.float32)
    self.kernel = kern / kern.sum()

  @property
  def dim(self):
    return 2 * self.motion.joint_pos.shape[1]

  # ------------------------------------------------------------------
  def init_state(self, gen):
    n, dev = self.num_envs, self.device
    z = lambda *shape, dtype=self.dtype: torch.zeros(shape, dtype=dtype,
                                                     device=dev)
    quat = z(n, self.n_bodies, 4)
    quat[..., 0] = 1.0
    # the bin statistics and the clock are float32, as in the JAX package
    st = {
        'time_steps': z(n, dtype=torch.int32),
        'time_left': torch.full((n,), 1e9, dtype=torch.float32, device=dev),
        'bin_failed': z(self.n_bins, dtype=torch.float32),
        'current_bin_failed': z(self.n_bins, dtype=torch.float32),
        'body_pos_relative_w': z(n, self.n_bodies, 3),
        'body_quat_relative_w': quat,
    }
    for k in _MOTION:
      st[f'motion/{k}'] = torch.as_tensor(getattr(self.motion, k),
                                          device=dev).to(self.dtype)
    for k in ('error_anchor_pos', 'error_anchor_rot', 'error_body_pos',
              'error_body_rot', 'error_joint_pos', 'error_joint_vel',
              'sampling_entropy', 'sampling_top1_prob'):
      st[f'metric/{k}'] = z(n)
    return st

  # motion lookups -----------------------------------------------------
  def joint_pos_target(self, st):
    return st['motion/joint_pos'][st['time_steps']]

  def joint_vel_target(self, st):
    return st['motion/joint_vel'][st['time_steps']]

  def body_pos_w(self, st, ctx):
    return (st['motion/body_pos_w'][st['time_steps']]
            + ctx.env_origins[:, None, :])

  def body_quat_w(self, st):
    return st['motion/body_quat_w'][st['time_steps']]

  def body_lin_vel_w(self, st):
    return st['motion/body_lin_vel_w'][st['time_steps']]

  def body_ang_vel_w(self, st):
    return st['motion/body_ang_vel_w'][st['time_steps']]

  def anchor_pos_w(self, st, ctx):
    return self.body_pos_w(st, ctx)[:, self.motion_anchor_idx]

  def anchor_quat_w(self, st):
    return self.body_quat_w(st)[:, self.motion_anchor_idx]

  # robot lookups ------------------------------------------------------
  def robot_body_pos_w(self, ctx):
    return self.view.body_pos_w(ctx.data, self.body_indexes)

  def robot_body_quat_w(self, ctx):
    return self.view.body_quat_w(ctx.data, self.body_indexes)

  def robot_body_lin_vel_w(self, ctx):
    return self.view.body_lin_vel_w(ctx.data, self.body_indexes)

  def robot_body_ang_vel_w(self, ctx):
    return self.view.body_ang_vel_w(ctx.data, self.body_indexes)

  def robot_anchor_pos_w(self, ctx):
    return self.view.body_pos_w(ctx.data)[:, self.robot_anchor_idx]

  def robot_anchor_quat_w(self, ctx):
    return self.view.body_quat_w(ctx.data)[:, self.robot_anchor_idx]

  def value(self, st):
    return torch.cat([self.joint_pos_target(st), self.joint_vel_target(st)],
                     -1)

  # ------------------------------------------------------------------
  def _adaptive_probs(self, st):
    p = st['bin_failed'] + self.cfg.adaptive_uniform_ratio / float(
        self.n_bins)
    # non-causal smoothing with replicate right-padding
    k = self.cfg.adaptive_kernel_size
    padded = torch.cat([p, p[-1:].repeat(max(k - 1, 0))])
    idx = ix(np.arange(self.n_bins)[:, None] + np.arange(k)[None, :],
             p.device)
    p = (padded[idx] * table(self.kernel, p.dtype, p.device)[None, :]).sum(
        -1)
    return p / p.sum()

  def _sample_time_steps(self, st, gen):
    """(start step of every env, `st` with the sampling metrics)."""
    n, T = self.num_envs, self.motion.time_step_total
    if self.cfg.disable_adaptive_sampling:
      return torch.zeros(n, dtype=torch.int32, device=self.device), st
    probs = self._adaptive_probs(st)
    # the JAX package draws jax.random.categorical on log(probs + 1e-12):
    # these are the probabilities those logits give
    p = torch.softmax(torch.log(probs + 1e-12), -1)
    bins = tmath.env_rows(gen, lambda s: torch.multinomial(
        p, s[0], replacement=True, generator=gen), (n,))
    frac = tmath.sample_uniform(gen, 0.0, 1.0, (n,), self.dtype)
    new_ts = ((bins + frac) / self.n_bins * (T - 1)).to(torch.int32)
    st = dict(st)
    H = -(probs * torch.log(probs + 1e-12)).sum() / math.log(self.n_bins)
    st['metric/sampling_entropy'] = H.to(self.dtype).expand(n)
    st['metric/sampling_top1_prob'] = probs.max().to(self.dtype).expand(n)
    return new_ts, st

  def _record_failures(self, st, ctx, mask):
    """Add the terminated (not timed-out) envs among `mask` to the failure
    counts of their clip bins."""
    T = self.motion.time_step_total
    bins = torch.clamp((st['time_steps'] * self.n_bins) // max(T, 1), 0,
                       self.n_bins - 1)
    failed = (mask & ctx.terminated).to(torch.float32)
    counts = torch.zeros_like(st['current_bin_failed']).index_add_(
        0, bins, failed)
    st = dict(st)
    st['current_bin_failed'] = st['current_bin_failed'] + counts
    return st

  def reset(self, state, ctx, mask, gen):
    """Record the failures of the masked envs and draw their start steps;
    the RSI writes to the data are the reset event `reset_to_motion`'s."""
    st = self._record_failures(state, ctx, mask)
    new_ts, st = self._sample_time_steps(st, gen)
    st['time_steps'] = torch.where(mask, new_ts, st['time_steps'])
    return st

  def compute(self, state, ctx, gen, dt):
    """Per-step update: advance time, loop-resample finished motions,
    recompute the anchor-aligned relative targets, EMA of bin failures."""
    st = self._update_metrics(dict(state), ctx, dt)
    st['time_steps'] = st['time_steps'] + 1
    ended = st['time_steps'] >= self.motion.time_step_total
    new_ts, st = self._sample_time_steps(st, gen)
    st['time_steps'] = torch.where(ended, new_ts, st['time_steps'])

    # anchor-aligned relative body targets, a yaw-only delta
    anchor_pos = self.anchor_pos_w(st, ctx)
    anchor_quat = self.anchor_quat_w(st)
    r_anchor_pos = self.robot_anchor_pos_w(ctx)
    r_anchor_quat = self.robot_anchor_quat_w(ctx)
    delta_pos = torch.cat([r_anchor_pos[:, :2], anchor_pos[:, 2:]], -1)
    delta_ori = tmath.yaw_quat(
        tmath.quat_mul(r_anchor_quat, tmath.quat_inv(anchor_quat)))[:, None]
    st['body_quat_relative_w'] = tmath.quat_mul(delta_ori,
                                                self.body_quat_w(st))
    st['body_pos_relative_w'] = delta_pos[:, None, :] + tmath.quat_apply(
        delta_ori, self.body_pos_w(st, ctx) - anchor_pos[:, None, :])

    # EMA of failure bins, over the failures of every rank's envs
    world = ctx.world
    if world is not None and world.sharded:
      from mjlab_torch.parallel.sharding import all_reduce_flat
      st['current_bin_failed'], = all_reduce_flat(
          [st['current_bin_failed']], world)
    a = self.cfg.adaptive_alpha
    st['bin_failed'] = a * st['current_bin_failed'] + (1 - a) * st[
        'bin_failed']
    st['current_bin_failed'] = torch.zeros_like(st['current_bin_failed'])
    return st

  def _update_metrics(self, st, ctx, dt):
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
    view = self.view
    st['metric/error_anchor_pos'] = norm(
        self.anchor_pos_w(st, ctx) - self.robot_anchor_pos_w(ctx))
    st['metric/error_anchor_rot'] = tmath.quat_error_magnitude(
        self.anchor_quat_w(st), self.robot_anchor_quat_w(ctx))
    st['metric/error_body_pos'] = norm(
        st['body_pos_relative_w'] - self.robot_body_pos_w(ctx)).mean(-1)
    st['metric/error_body_rot'] = tmath.quat_error_magnitude(
        st['body_quat_relative_w'], self.robot_body_quat_w(ctx)).mean(-1)
    st['metric/error_joint_pos'] = norm(
        self.joint_pos_target(st) - view.joint_pos(ctx.data))
    st['metric/error_joint_vel'] = norm(
        self.joint_vel_target(st) - view.joint_vel(ctx.data))
    return st

  def debug_vis(self, state, env, env_index: int, vis) -> None:
    """The ghost robot at env `env_index`'s anchor-aligned motion target
    and a marker at each target body."""
    e = env_index
    t = int(state['time_steps'][e])
    # the aligned targets: body 0 of the tracked list is the robot's root
    pos_rel = state['body_pos_relative_w'][e].cpu().numpy()
    quat_rel = state['body_quat_relative_w'][e].cpu().numpy()
    joint_pos = state['motion/joint_pos'][t].cpu().numpy()
    qpos = np.concatenate([pos_rel[0], quat_rel[0], joint_pos])
    vis.add_ghost_qpos(qpos, alpha=0.35)
    for p in pos_rel:
      vis.add_sphere(p, radius=0.02, color=(1.0, 0.3, 0.3, 0.8))


def reset_to_motion(ctx, data, mask, gen, command_name: str = 'motion'):
  """Reset event, RSI: write the motion's reference state at each env's
  freshly drawn step, with the pose, velocity and joint randomization of
  the command cfg, into the masked envs."""
  term: MotionCommand = ctx.command_terms[command_name]
  st = ctx.state.command[command_name]
  cfg: MotionCommandCfg = term.cfg
  view = term.view
  n = ctx.num_envs
  dtype = data.qpos.dtype

  root_pos = term.body_pos_w(st, ctx)[:, 0]
  root_ori = term.body_quat_w(st)[:, 0]
  root_lin = term.body_lin_vel_w(st)[:, 0]
  root_ang = term.body_ang_vel_w(st)[:, 0]

  samp = _sample_axes(gen, cfg.pose_range, n, dtype)
  root_pos = root_pos + samp[:, :3]
  dq = tmath.quat_from_euler_xyz(samp[:, 3], samp[:, 4], samp[:, 5])
  root_ori = tmath.quat_mul(dq, root_ori)
  samp = _sample_axes(gen, cfg.velocity_range, n, dtype)
  root_lin = root_lin + samp[:, :3]
  root_ang = root_ang + samp[:, 3:]

  target = term.joint_pos_target(st)
  jp = target + tmath.sample_uniform(gen, cfg.joint_position_range[0],
                                     cfg.joint_position_range[1],
                                     target.shape, dtype)
  lim = view.soft_joint_pos_limits
  jp = torch.minimum(torch.maximum(jp, lim[:, 0]), lim[:, 1])
  data = view.write_joint_state(data, jp, term.joint_vel_target(st),
                                mask=mask)
  # a free joint's angular velocity is body-local
  root_state = torch.cat(
      [root_pos, root_ori, root_lin,
       tmath.quat_apply_inverse(root_ori, root_ang)], -1)
  return view.write_root_state(data, root_state, mask)
