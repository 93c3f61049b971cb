"""Web viewer through viser.

Counterpart of mjlab_tpu/viewer/viser_viewer.py: one mesh handle a geom
(numpy triangulations of viewer/primitives.py, a mesh geom's own mesh),
posed each frame from the selected env's qpos on a CPU MjData; the ghost
robot, arrows and spheres of the command terms' `debug_vis`; contact
arrows of the selected env; a per-term reward readout with uplot strip
charts; pause, env and contact controls. viser is optional: without it
`setup` raises an ImportError that names it. The model is the scene's
compiled mujoco.MjModel (offscreen.scene_mj_model), so the viewer needs
mujoco; viser and mujoco are imported when the viewer is set up."""

from __future__ import annotations

import numpy as np

from mjlab_torch.viewer.base import BaseViewer
from mjlab_torch.viewer.native import draw_commands
from mjlab_torch.viewer.primitives import arrow_mesh, geom_mesh, mujoco_mesh


def _require_viser():
  try:
    import viser  # noqa: F401
    return viser
  except ImportError as e:
    raise ImportError(
        'the web viewer requires the optional `viser` package '
        '(pip install viser); the native viewer '
        '(mjlab_torch.viewer.native) has no extra dependencies') from e


def _mat_to_wxyz(mat9) -> tuple:
  import mujoco
  quat = np.empty(4)
  mujoco.mju_mat2Quat(quat, np.asarray(mat9, np.float64))
  return tuple(quat)


class _ViserDebugVis:
  """DebugVisualizer protocol adapter: arrows/spheres/ghost drawn as viser
  scene nodes, reused across frames by slot index."""

  def __init__(self, viewer: 'ViserViewer'):
    self.viewer = viewer
    self._arrow_slot = 0
    self._sphere_slot = 0

  def clear(self):
    self._arrow_slot = 0
    self._sphere_slot = 0
    self.viewer._ghost_live = False

  def finish(self):
    self.viewer._hide_debug_from(self._arrow_slot, self._sphere_slot)

  def add_arrow(self, start, end, color=(1, 0, 0, 1), radius=0.02):
    self.viewer._place_arrow(self._arrow_slot, np.asarray(start, float),
                             np.asarray(end, float), color, radius)
    self._arrow_slot += 1

  def add_sphere(self, pos, radius=0.05, color=(0, 1, 0, 0.5)):
    self.viewer._place_sphere(self._sphere_slot, np.asarray(pos, float),
                              radius, color)
    self._sphere_slot += 1

  def add_ghost_qpos(self, qpos, alpha=0.3, rgb=(0.2, 0.6, 1.0)):
    self.viewer._pose_ghost(qpos)
    self.viewer._ghost_live = True


class ViserViewer(BaseViewer):
  """Browser-based viewer: one mesh handle per geom, posed each frame from
  the device batch; ghost robot and debug arrows from the command terms,
  contact-force arrows, reward readout."""

  _MAX_ARROWS = 32
  _MAX_SPHERES = 64

  def setup(self):
    viser = _require_viser()
    import mujoco

    from mjlab_torch.viewer.offscreen import scene_mj_model
    self._mujoco = mujoco
    self.server = viser.ViserServer()
    self.mj = scene_mj_model(self.env)
    self.md = mujoco.MjData(self.mj)

    self._handles = self._add_geom_handles('/robot', alpha=None)
    self._ghost_handles = self._add_geom_handles(
        '/ghost', alpha=0.35, color=(0.2, 0.6, 1.0), visible=False,
        skip_static=True)
    self._ghost_md = mujoco.MjData(self.mj)
    self._ghost_live = False

    # debug arrow/sphere slot pools (created lazily, reused per frame)
    self._arrows = {}
    self._spheres = {}
    self.debug_vis = _ViserDebugVis(self)

    # playback GUI
    self._pause_btn = self.server.gui.add_button('Pause/Resume')
    self._pause_btn.on_click(lambda _: self.toggle_pause())
    self._env_slider = self.server.gui.add_slider(
        'env', min=0, max=self.env.num_envs - 1, step=1, initial_value=0)
    self._contact_chk = self.server.gui.add_checkbox(
        'contact forces', initial_value=False)
    self._reward_md = self.server.gui.add_markdown('(rewards)')
    self._reward_hist: dict = {}
    # live per-term strip plots: uplot charts, checkbox-gated; the
    # sparkline table alone on viser builds without gui.add_uplot
    self._plots_enabled = None
    self._plot_handles: dict = {}
    self._plot_window = 150
    if hasattr(self.server.gui, 'add_uplot'):
      self._plots_enabled = self.server.gui.add_checkbox(
          'reward plots', initial_value=False)

      def _toggle(_):
        for h in self._plot_handles.values():
          h.visible = self._plots_enabled.value
      self._plots_enabled.on_update(_toggle)

  # -- handle construction ------------------------------------------------
  def _add_geom_handles(self, prefix: str, alpha, color=None,
                        visible: bool = True, skip_static: bool = False):
    handles = []
    for g in range(self.mj.ngeom):
      if skip_static and self.mj.geom_bodyid[g] == 0:
        handles.append(None)
        continue
      mesh = geom_mesh(self.mj.geom_type[g], self.mj.geom_size[g])
      if mesh is None:
        mesh = mujoco_mesh(self.mj, g)
      if mesh is None:
        handles.append(None)
        continue
      verts, faces = mesh
      rgba = self.mj.geom_rgba[g]
      c = color or tuple(rgba[:3])
      a = rgba[3] if alpha is None else alpha
      h = self.server.scene.add_mesh_simple(
          f'{prefix}/geom_{g}', vertices=np.asarray(verts, np.float32),
          faces=np.asarray(faces, np.uint32), color=c,
          opacity=float(a), visible=visible)
      handles.append(h)
    return handles

  # -- debug-vis plumbing -------------------------------------------------
  def _place_arrow(self, slot: int, start, end, color, radius):
    if slot >= self._MAX_ARROWS:
      return
    vec = end - start
    length = float(np.linalg.norm(vec))
    if slot not in self._arrows:
      verts, faces = arrow_mesh(1.0, radius)
      self._arrows[slot] = self.server.scene.add_mesh_simple(
          f'/debug/arrow_{slot}', vertices=np.asarray(verts, np.float32),
          faces=np.asarray(faces, np.uint32), color=tuple(color[:3]),
          opacity=float(color[3]) if len(color) > 3 else 1.0)
    h = self._arrows[slot]
    h.visible = length > 1e-6
    if length <= 1e-6:
      return
    z = vec / length
    ref = np.asarray([0.0, 0.0, 1.0])
    v = np.cross(ref, z)
    w = 1.0 + float(ref @ z)
    quat = np.asarray([w, *v])
    n = np.linalg.norm(quat)
    quat = quat / n if n > 1e-9 else np.asarray([0.0, 1.0, 0.0, 0.0])
    h.position = tuple(start)
    h.wxyz = tuple(quat)
    h.scale = length

  def _place_sphere(self, slot: int, pos, radius, color):
    if slot >= self._MAX_SPHERES:
      return
    if slot not in self._spheres:
      self._spheres[slot] = self.server.scene.add_icosphere(
          f'/debug/sphere_{slot}', radius=1.0, color=tuple(color[:3]),
          opacity=float(color[3]) if len(color) > 3 else 1.0)
    h = self._spheres[slot]
    h.visible = True
    h.position = tuple(pos)
    h.scale = radius

  def _hide_debug_from(self, arrow_slot: int, sphere_slot: int):
    for s, h in self._arrows.items():
      if s >= arrow_slot:
        h.visible = False
    for s, h in self._spheres.items():
      if s >= sphere_slot:
        h.visible = False
    if not self._ghost_live:
      for h in self._ghost_handles:
        if h is not None:
          h.visible = False

  def _pose_ghost(self, qpos):
    mujoco = self._mujoco
    self._ghost_md.qpos[:len(qpos)] = np.asarray(qpos, np.float64)
    mujoco.mj_kinematics(self.mj, self._ghost_md)
    for g, h in enumerate(self._ghost_handles):
      if h is None:
        continue
      h.visible = True
      h.position = tuple(self._ghost_md.geom_xpos[g])
      h.wxyz = _mat_to_wxyz(self._ghost_md.geom_xmat[g])

  # -- frame sync ---------------------------------------------------------
  def sync_env_to_viewer(self):
    mujoco = self._mujoco
    self.env_index = int(self._env_slider.value)
    e = self.env_index
    self.md.qpos[:] = self.env.state.data.qpos[e].cpu().numpy()
    mujoco.mj_forward(self.mj, self.md)
    for g, h in enumerate(self._handles):
      if h is None:
        continue
      h.position = tuple(self.md.geom_xpos[g])
      h.wxyz = _mat_to_wxyz(self.md.geom_xmat[g])
    self._draw_debug()
    self._draw_contacts()
    self._update_rewards()

  def _draw_debug(self):
    self.debug_vis.clear()
    draw_commands(self.env, self.env_index, self.debug_vis, 'viser')
    self.debug_vis.finish()

  def _draw_contacts(self):
    """Contact arrows of the selected env: the normals of its first 8
    active contact slots, read from its rows of the device contact set."""
    if not self._contact_chk.value:
      return
    try:
      data = self.env.state.data
      con = data.contact
      e = self.env_index
      dist = con.dist[e].cpu().numpy()
      margin = con.includemargin[e].cpu().numpy()
      pos = con.pos[e].cpu().numpy()
      frame = con.frame[e].cpu().numpy()
      active = np.nonzero(dist < margin)[0][:8]
      base = self.debug_vis._arrow_slot
      for i, c in enumerate(active):
        n = frame[c, 0]
        self._place_arrow(base + i, pos[c], pos[c] + 0.15 * n,
                          (0.9, 0.2, 0.2, 0.9), 0.008)
    except Exception:
      pass

  def _update_rewards(self):
    """Per-term episode reward readout: a live markdown table with a
    sparkline a term, and the strip charts."""
    extras = getattr(self.env, 'last_extras', None)
    if not isinstance(extras, dict):
      return
    rows = []
    for k, v in extras.items():
      if 'Reward' in k:
        try:
          val = float(v)
        except Exception:
          continue
        hist = self._reward_hist.setdefault(k, [])
        hist.append(val)
        del hist[:-max(120, self._plot_window)]
        if self._plots_enabled is not None:
          self._update_plot(k, hist)
        spark = ''.join('▁▂▃▄▅▆▇█'[min(7, int(8 * (x - min(hist)) /
                        (max(hist) - min(hist) + 1e-9)))] for x in hist[-40:])
        rows.append(f'| {k.split("/")[-1]} | {val:8.4f} | `{spark}` |')
    if rows:
      self._reward_md.content = (
          '| term | value | history |\n|---|---|---|\n' + '\n'.join(rows))

  def _update_plot(self, term: str, hist: list, max_terms: int = 12):
    """One uplot strip chart per reward term, its rolling window anchored
    at x in [-window, 0]."""
    import viser.uplot as uplot  # gated by add_uplot hasattr check

    h = self._plot_handles.get(term)
    if h is None:
      if len(self._plot_handles) >= max_terms:
        return
      series = (uplot.Series(label='steps'),
                uplot.Series(label=term.split('/')[-1], stroke='#1f77b4',
                             width=2))
      h = self.server.gui.add_uplot(
          data=(np.array([], np.float64), np.array([], np.float64)),
          series=series,
          scales={'x': uplot.Scale(time=False, auto=False,
                                   range=(-self._plot_window, 0)),
                  'y': uplot.Scale(auto=True)},
          aspect=2.0)
      h.visible = self._plots_enabled.value
      self._plot_handles[term] = h
    y = np.asarray(hist[-self._plot_window:], np.float64)
    x = np.arange(-len(y) + 1, 1, dtype=np.float64)
    h.data = (x, y)

  def teardown(self):
    self.server.stop()
