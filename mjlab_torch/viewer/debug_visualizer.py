"""Debug visualization: arrows, spheres and ghost robots.

Counterpart of mjlab_tpu/viewer/debug_visualizer.py. The command terms'
`debug_vis` hooks draw through the `DebugVisualizer` protocol (the velocity
command's arrows, the motion command's ghost robot and target markers);
`MujocoSceneVisualizer` draws into an mjvScene's user geoms (the native
viewer's `user_scn`), `NullVisualizer` draws nothing. Only the scene
visualizer needs mujoco, imported when one is made."""

from __future__ import annotations

from typing import Protocol

import numpy as np


class DebugVisualizer(Protocol):

  def add_arrow(self, start, end, color=(1, 0, 0, 1), radius=0.02): ...

  def add_sphere(self, pos, radius=0.05, color=(0, 1, 0, 0.5)): ...

  def add_ghost_qpos(self, qpos, alpha=0.3): ...

  def clear(self): ...


class NullVisualizer:
  """No-op sink used when no viewer is attached."""

  def add_arrow(self, *a, **k):
    pass

  def add_sphere(self, *a, **k):
    pass

  def add_ghost_qpos(self, *a, **k):
    pass

  def clear(self):
    pass


class MujocoSceneVisualizer:
  """Draws debug geoms into an mjvScene's user geom slots (the native
  viewer passes `viewer.user_scn`). With a compiled mujoco.MjModel
  attached, a ghost robot is drawn by posing a private MjData with
  `mj_kinematics` and emitting every geom of a body other than the world
  translucently."""

  def __init__(self, scene, mj_model=None):
    import mujoco
    self._mujoco = mujoco
    self.scn = scene
    self.mj = mj_model
    self._ghost_md = mujoco.MjData(mj_model) if mj_model is not None else None

  def clear(self):
    self.scn.ngeom = 0

  def _add(self, gtype, size, pos, mat, rgba):
    mj = self._mujoco
    if self.scn.ngeom >= self.scn.maxgeom:
      return
    g = self.scn.geoms[self.scn.ngeom]
    mj.mjv_initGeom(g, gtype, np.asarray(size, np.float64),
                    np.asarray(pos, np.float64),
                    np.asarray(mat, np.float64).reshape(9),
                    np.asarray(rgba, np.float32))
    self.scn.ngeom += 1

  def add_arrow(self, start, end, color=(1, 0, 0, 1), radius=0.02):
    mj = self._mujoco
    start = np.asarray(start, np.float64)
    end = np.asarray(end, np.float64)
    if self.scn.ngeom >= self.scn.maxgeom:
      return
    g = self.scn.geoms[self.scn.ngeom]
    mj.mjv_initGeom(g, mj.mjtGeom.mjGEOM_ARROW, np.zeros(3), np.zeros(3),
                    np.eye(3).reshape(9), np.asarray(color, np.float32))
    mj.mjv_connector(g, mj.mjtGeom.mjGEOM_ARROW, radius, start, end)
    self.scn.ngeom += 1

  def add_sphere(self, pos, radius=0.05, color=(0, 1, 0, 0.5)):
    mj = self._mujoco
    self._add(mj.mjtGeom.mjGEOM_SPHERE, [radius, 0, 0], pos,
              np.eye(3), color)

  def add_ghost_qpos(self, qpos, alpha=0.3, rgb=(0.2, 0.6, 1.0)):
    """FK-pose a private MjData at `qpos` and draw every robot primitive
    geom translucently (visual group<=3, non-plane/hfield)."""
    if self._ghost_md is None:
      return
    mj = self._mujoco
    m, md = self.mj, self._ghost_md
    md.qpos[:len(qpos)] = np.asarray(qpos, np.float64)
    mj.mj_kinematics(m, md)
    skip = (mj.mjtGeom.mjGEOM_PLANE, mj.mjtGeom.mjGEOM_HFIELD)
    rgba = np.asarray(list(rgb) + [alpha], np.float32)
    for g in range(m.ngeom):
      gtype = m.geom_type[g]
      if gtype in skip or m.geom_bodyid[g] == 0:
        continue
      self._add(gtype, m.geom_size[g], md.geom_xpos[g],
                md.geom_xmat[g], rgba)
