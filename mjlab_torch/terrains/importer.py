"""Terrain importer: the plane terrain and the grid of env origins.

Counterpart of mjlab_tpu/terrains/importer.py for `terrain_type='plane'`.
There the importer adds the plane to the scene's MjSpec; the port is handed
the compiled scene, so it checks that the scene holds a plane geom named
`terrain` (the name ground-contact sensors filter on) and lays out the
origins.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mjlab_torch.physics.io import names_of
from mjlab_torch.physics.types import GeomType


@dataclasses.dataclass
class TerrainImporterCfg:
  terrain_type: str = 'plane'
  env_spacing: float = 2.0


def grid_origins(num_envs: int, spacing: float) -> np.ndarray:
  """(num_envs, 3) origins on a square grid centred on the world origin, at
  z = 0."""
  side = int(np.ceil(np.sqrt(num_envs)))
  idx = np.arange(num_envs)
  xy = np.stack([idx % side, idx // side], -1).astype(np.float64)
  xy = (xy - xy.mean(axis=0)) * spacing
  return np.concatenate([xy, np.zeros((num_envs, 1))], -1)


class TerrainImporter:

  def __init__(self, cfg: TerrainImporterCfg, num_envs: int, mj_model):
    self.cfg = cfg
    self.num_envs = num_envs
    if cfg.terrain_type != 'plane':
      raise NotImplementedError(
          f'terrain_type {cfg.terrain_type!r} is not supported by '
          "mjlab_torch yet; use 'plane'")
    names = names_of(mj_model, 'geom', mj_model.ngeom)
    if 'terrain' not in names or int(
        mj_model.geom_type[names.index('terrain')]) != int(GeomType.PLANE):
      raise ValueError("the compiled scene has no plane geom named 'terrain'")
    self.env_origins = grid_origins(num_envs, cfg.env_spacing)
    self.terrain_levels = np.zeros(num_envs, np.int32)
    self.terrain_types = np.zeros(num_envs, np.int32)
