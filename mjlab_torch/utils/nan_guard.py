"""NaN guard: detect non-finite physics state and dump a replayable
snapshot.

Counterpart of mjlab_tpu/utils/nan_guard.py (and of the reference mjlab's
utils/nan_guard.py). On the first step where any env's qpos, qvel or qacc
is non-finite, the guard writes `nan_dump_<stamp>.npz` (the offending envs'
recent state) and the scene's compiled model as `model.npz` (a
`physics.io.ModelArrays` snapshot; the card has no `mujoco`), which
`python -m mjlab_torch.scripts.nan_viz` reads.

The guard checks the state the physics produced, before anything
sanitizes it. Wrapping the env's own step function, the guard is attached
to the env for the length of each call (`ManagerBasedRlEnv.nan_guard`):
the env hands it the post-substep state and its non-finite mask before the
step's self-heal replaces non-finite values by zeros, and its flag joins
the step's one host read. So the guard costs no extra wait for the device.
Any other step function is checked on the state it returns, one host read
a step.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


def _nonfinite(d) -> torch.Tensor:
  """(N,) bool: the envs whose qpos, qvel or qacc holds a non-finite
  value."""
  fin = lambda a: torch.isfinite(a).all(dim=-1)
  return ~(fin(d.qpos) & fin(d.qvel) & fin(d.qacc))


class NanGuard:
  """Wraps an env step function. Usage:

    guard = NanGuard(env, out_dir='nan_dumps')
    step_fn = guard.wrap(env.step_fn)

  One-shot: it dumps once, on the first non-finite step, and checks
  nothing after that."""

  def __init__(self, env, out_dir: str = 'nan_dumps', history: int = 25,
               max_envs: int = 5):
    self.env = env
    self.out_dir = out_dir
    self.history = history
    self.max_envs = max_envs
    self._record_history = False
    self._fired = False
    self._handed = False  # the step in flight handed its state over
    self._last = None  # that step's (bad, qpos, qvel, qacc, time, step)
    self._ring = None  # history mode: (history, ...) tensors on the device
    self._recorded = 0  # steps written into the ring

  # -- what a step hands over (device tensors, no host read) -----------
  def observe(self, bad, qpos, qvel, qacc, t, step) -> None:
    """Take one step's state: its non-finite mask (N,), qpos, qvel, qacc,
    time, and the env's step count after it. In history mode the state is
    copied into the guard's device ring; otherwise only referenced."""
    self._handed = True
    self._last = (bad, qpos, qvel, qacc, t, step)
    if not self._record_history:
      return
    fields = {'qpos': qpos, 'qvel': qvel, 'qacc': qacc, 'time': t,
              'step': step}
    if self._ring is None:
      self._ring = {k: torch.zeros((self.history,) + tuple(v.shape),
                                   dtype=v.dtype, device=v.device)
                    for k, v in fields.items()}
    slot = self._recorded % self.history
    for k, v in fields.items():
      self._ring[k][slot].copy_(v)
    self._recorded += 1

  def settle(self, blew_up: bool) -> None:
    """The host's answer for the step observed last: dump if any env blew
    up and the guard has not fired yet."""
    if blew_up and not self._fired:
      self._dump()

  # -- host side ------------------------------------------------------
  def _dump(self):
    self._fired = True
    bad, qpos, qvel, qacc, t, step = self._last
    bad_ids = np.nonzero(bad.cpu().numpy())[0][:self.max_envs]
    ids = torch.as_tensor(bad_ids, device=bad.device)
    if self._record_history:
      n = min(self._recorded, self.history)
      order = [(self._recorded - n + i) % self.history for i in range(n)]
      hist = {k: v[order] for k, v in self._ring.items()}
      hist = {k: v if k == 'step' else v[:, ids] for k, v in hist.items()}
    else:
      hist = {'qpos': qpos[ids][None], 'qvel': qvel[ids][None],
              'qacc': qacc[ids][None], 'time': t[ids][None],
              'step': step[None]}
    hist = {k: v.cpu().numpy() for k, v in hist.items()}
    os.makedirs(self.out_dir, exist_ok=True)
    stamp = time.strftime('%Y%m%d_%H%M%S')
    path = os.path.join(self.out_dir, f'nan_dump_{stamp}.npz')
    np.savez(
        path,
        bad_env_ids=bad_ids,
        steps=np.array([int(s) for s in hist['step']]),
        qpos=hist['qpos'],
        qvel=hist['qvel'],
        qacc=hist['qacc'],
        time=hist['time'],
    )
    mj_model = getattr(getattr(self.env, 'scene', None), 'mj_model', None)
    if mj_model is not None:
      from mjlab_torch.physics.io import ModelArrays
      snap = (mj_model if isinstance(mj_model, ModelArrays)
              else ModelArrays.of(mj_model))
      snap.save(os.path.join(self.out_dir, 'model.npz'))
    print(f'[NanGuard] non-finite state in envs {bad_ids.tolist()}; '
          f'dumped {len(hist["step"])}-step history to {path}', flush=True)

  # -- the wrapper ----------------------------------------------------
  def wrap(self, step_fn, record_history: bool = False):
    """record_history=False (default): only the step that goes
    non-finite is dumped. record_history=True: the last `history` steps
    are kept in a ring on the device (about 44 MB for the G1 at 4096 envs
    and the default 25) and dumped with it."""
    self._record_history = record_history
    attach = hasattr(self.env, 'nan_guard')

    def guarded(state, action):
      if self._fired:
        return step_fn(state, action)
      self._handed = False
      if attach:
        before, self.env.nan_guard = self.env.nan_guard, self
      try:
        state, out = step_fn(state, action)
      finally:
        if attach:
          self.env.nan_guard = before
      if not self._handed:  # not the env's step: check what it returns
        d = state.data
        bad = _nonfinite(d)
        self.observe(bad, d.qpos, d.qvel, d.qacc, d.time, state.common_step)
        self.settle(bool(bad.any()))
      return state, out

    return guarded
