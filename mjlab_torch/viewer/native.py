"""Native interactive viewer: the policy in the loop in MuJoCo's GUI
(`mujoco.viewer.launch_passive`).

Counterpart of mjlab_tpu/viewer/native.py. Each frame the selected env's
qpos and qvel are copied from the batch on the device to a CPU MjData and
`mj_forward`ed for display; a perturbation made in the GUI is written back
in place into that env's row of the device's `xfrc_applied`, and into no
other. The model is the scene's compiled mujoco.MjModel
(offscreen.scene_mj_model), so the viewer needs mujoco and a display.

Keys: Space pause | ]/[ env next/prev | +/- speed | Backspace reset."""

from __future__ import annotations

import torch

from mjlab_torch.viewer.base import BaseViewer


def draw_commands(env, env_index: int, vis, tag: str) -> None:
  """Each command term's `debug_vis` of env `env_index` into `vis`; a hook
  that fails is printed and the frame goes on."""
  mgr = getattr(env, 'command_manager', None)
  if mgr is None:
    return
  for name, term in mgr.terms.items():
    try:
      term.debug_vis(env.state.command[name], env, env_index, vis)
    except Exception as exc:
      print(f'[{tag}] debug_vis({name}) failed: {exc!r}')


class NativeMujocoViewer(BaseViewer):

  def setup(self):
    import mujoco
    import mujoco.viewer

    from mjlab_torch.viewer.debug_visualizer import MujocoSceneVisualizer
    from mjlab_torch.viewer.offscreen import scene_mj_model
    self._mujoco = mujoco
    self.mj = scene_mj_model(self.env)
    self.md = mujoco.MjData(self.mj)
    self.viewer = mujoco.viewer.launch_passive(
        self.mj, self.md, key_callback=self._on_key)
    self.debug_vis = MujocoSceneVisualizer(self.viewer.user_scn, self.mj)

  def _on_key(self, keycode: int):
    key = chr(keycode) if 0 <= keycode < 0x110000 else ''
    if key == ' ':
      self.toggle_pause()
    elif key == ']':
      self.next_env()
    elif key == '[':
      self.prev_env()
    elif key in ('+', '='):
      self.speed_up()
    elif key == '-':
      self.speed_down()
    elif keycode == 259:  # backspace
      self.request_reset()

  def is_running(self) -> bool:
    return self._running and self.viewer.is_running()

  def sync_env_to_viewer(self):
    e = self.env_index
    data = self.env.state.data
    self.md.qpos[:] = data.qpos[e].cpu().numpy()
    self.md.qvel[:] = data.qvel[e].cpu().numpy()
    self._mujoco.mj_forward(self.mj, self.md)
    self.debug_vis.clear()
    draw_commands(self.env, e, self.debug_vis, 'viewer')
    self.viewer.sync()

  def sync_viewer_to_env(self):
    # the GUI's perturbation wrenches into the selected env's row
    if self.md.xfrc_applied.any():
      xfrc = self.env.state.data.xfrc_applied
      xfrc[self.env_index].copy_(torch.from_numpy(self.md.xfrc_applied))

  def teardown(self):
    self.viewer.close()


def run_viewer(env, policy, env_index: int = 0, fps: float = 50.0):
  NativeMujocoViewer(env, policy, env_index=env_index, fps=fps).run()
