"""Viewer base: the policy-in-the-loop playback engine.

Counterpart of mjlab_tpu/viewer/base.py: pause and resume, playback speed
(0.01x to 1x of real time), env switching, reset requests, and the mean
time of the simulation and the drawing of a frame. The front ends (the
native viewer, the viser viewer) subclass it and implement the sync
hooks."""

from __future__ import annotations

import time
from typing import Any, Callable, Protocol


class EnvProtocol(Protocol):
  """What a viewer needs from an env."""

  def reset(self, seed=None): ...

  def step(self, action): ...

  @property
  def num_envs(self) -> int: ...


PolicyProtocol = Callable[[Any], Any]

SPEEDS = (0.01, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0)


class Timer:
  """Rolling-average phase timer."""

  def __init__(self, window: int = 50):
    self.window = window
    self.samples: list[float] = []
    self._t0 = 0.0

  def tic(self):
    self._t0 = time.perf_counter()

  def toc(self) -> float:
    dt = time.perf_counter() - self._t0
    self.samples.append(dt)
    if len(self.samples) > self.window:
      self.samples.pop(0)
    return dt

  @property
  def mean_ms(self) -> float:
    return 1e3 * sum(self.samples) / max(len(self.samples), 1)


class BaseViewer:
  """Run loop: policy -> env.step -> front-end sync, with interactive
  pause, speed and env-switch state."""

  def __init__(self, env: EnvProtocol, policy: PolicyProtocol,
               env_index: int = 0, fps: float = 50.0):
    self.env = env
    self.policy = policy
    self.env_index = env_index
    self.fps = fps
    self.paused = False
    self.speed_idx = len(SPEEDS) - 1
    self.reset_requested = False
    self.sim_timer = Timer()
    self.render_timer = Timer()
    self._obs = None
    self._running = True

  # -- controls ---------------------------------------------------------
  def toggle_pause(self):
    self.paused = not self.paused

  def speed_up(self):
    self.speed_idx = min(self.speed_idx + 1, len(SPEEDS) - 1)

  def speed_down(self):
    self.speed_idx = max(self.speed_idx - 1, 0)

  @property
  def speed(self) -> float:
    return SPEEDS[self.speed_idx]

  def next_env(self):
    self.env_index = (self.env_index + 1) % self.env.num_envs

  def prev_env(self):
    self.env_index = (self.env_index - 1) % self.env.num_envs

  def request_reset(self):
    self.reset_requested = True

  def close(self):
    self._running = False

  # -- front-end hooks --------------------------------------------------
  def setup(self):
    """Open windows / start servers."""

  def sync_env_to_viewer(self):
    """Copy the selected env's state into the display."""

  def sync_viewer_to_env(self):
    """Write interactive perturbations back into the sim."""

  def is_running(self) -> bool:
    return self._running

  def teardown(self):
    pass

  # -- loop -------------------------------------------------------------
  def step_simulation(self):
    self.sim_timer.tic()
    action = self.policy(self._obs)
    self._obs, *_ = self.env.step(action)
    self.sim_timer.toc()

  def run(self):
    self._obs, _ = self.env.reset()
    self.setup()
    try:
      while self.is_running():
        t_frame = time.perf_counter()
        if self.reset_requested:
          self._obs, _ = self.env.reset()
          self.reset_requested = False
        self.sync_viewer_to_env()
        if not self.paused:
          self.step_simulation()
        self.render_timer.tic()
        self.sync_env_to_viewer()
        self.render_timer.toc()
        # real-time pacing scaled by playback speed
        budget = 1.0 / (self.fps * self.speed)
        leftover = budget - (time.perf_counter() - t_frame)
        if leftover > 0:
          time.sleep(leftover)
    finally:
      self.teardown()

  @property
  def stats(self) -> dict:
    return {'sim_ms': self.sim_timer.mean_ms,
            'render_ms': self.render_timer.mean_ms,
            'env_index': self.env_index,
            'speed': self.speed,
            'paused': self.paused}
