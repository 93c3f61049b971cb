"""Terrain importer: the plane terrain or a generated sub-terrain grid, and
the env origins laid over it.

Counterpart of mjlab_tpu/terrains/importer.py. A scene composed from its
cfgs hands the importer its MjSpec (`spec=`), and the importer builds the
terrain into it: a plane or the generator's heightfield, the geom named
`terrain` either way. Built in place, not attached, the terrain's names
stay global, so the entities' contact sensors resolve `geom2='terrain'`
across the attach boundary (MjSpec.attach prefixes every attached name).
A scene loaded as a compiled model is checked instead (`check_scene`): it
must hold the terrain's geom `terrain`, a plane or a heightfield of the
generator's raster size (asset_zoo/rough_scene.py puts the same
generator's heightfield into a flat snapshot).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mjlab_torch.physics.io import names_of
from mjlab_torch.physics.types import GeomType
from mjlab_torch.terrains.generator import TerrainGenerator


@dataclasses.dataclass
class TerrainImporterCfg:
  terrain_type: str = 'plane'  # 'plane' | 'generator'
  terrain_generator: 'object | None' = None  # TerrainGeneratorCfg
  env_spacing: float = 2.0
  color: tuple = (0.2, 0.3, 0.4)  # the plane's


def grid_origins(num_envs: int, spacing: float) -> np.ndarray:
  """(num_envs, 3) origins on a square grid centred on the world origin, at
  z = 0."""
  side = int(np.ceil(np.sqrt(num_envs)))
  idx = np.arange(num_envs)
  xy = np.stack([idx % side, idx // side], -1).astype(np.float64)
  xy = (xy - xy.mean(axis=0)) * spacing
  return np.concatenate([xy, np.zeros((num_envs, 1))], -1)


class TerrainImporter:
  """The terrain's env origins; for a generator terrain also the generator,
  each env's level (row) and type (column), and the (level, type) table of
  spawn origins that the terrain-level curriculum moves envs over.
  `check_scene` checks a compiled scene against it.

  `num_envs` is the global env count; with `rows` (one rank's slice of a
  sharded env, parallel/sharding.py) the per-env arrays are those rows of
  the global env's."""

  def __init__(self, cfg: TerrainImporterCfg, num_envs: int,
               rows: 'slice | None' = None, spec=None):
    self.cfg = cfg
    self._lay_out(num_envs)
    if spec is not None:
      self.build(spec)
    rows = slice(None) if rows is None else rows
    self.env_origins = self.env_origins[rows]
    self.terrain_levels = self.terrain_levels[rows]
    self.terrain_types = self.terrain_types[rows]
    self.num_envs = len(self.env_origins)

  def _lay_out(self, num_envs: int) -> None:
    cfg = self.cfg
    self.generator: 'TerrainGenerator | None' = None
    if cfg.terrain_type == 'plane':
      self.env_origins = grid_origins(num_envs, cfg.env_spacing)
      self.terrain_levels = np.zeros(num_envs, np.int32)
      self.terrain_types = np.zeros(num_envs, np.int32)
    elif cfg.terrain_type == 'generator':
      if cfg.terrain_generator is None:
        raise ValueError('terrain_generator cfg required')
      gen = TerrainGenerator(cfg.terrain_generator)
      self.generator = gen
      # env e starts at a random level below the ratio's row, its type
      # striped over the columns
      rng = np.random.default_rng(0)
      num_rows, num_cols = gen.origins.shape[:2]
      max_init = max(0, int(np.ceil(num_rows * getattr(
          cfg.terrain_generator, 'max_init_terrain_level_ratio', 0.5))))
      self.terrain_levels = rng.integers(0, max(max_init, 1), num_envs)
      self.terrain_types = (np.arange(num_envs) % num_cols).astype(np.int32)
      self.env_origins = gen.origins[self.terrain_levels, self.terrain_types]
    else:
      raise ValueError(f'unknown terrain_type {cfg.terrain_type!r}')

  def build(self, spec) -> None:
    """Build the terrain into the scene's MjSpec (needs mujoco)."""
    if self.generator is not None:
      self.generator.build(spec)
      return
    import mujoco
    spec.worldbody.add_geom(
        name='terrain', type=mujoco.mjtGeom.mjGEOM_PLANE,
        size=[0.0, 0.0, 0.05], rgba=list(self.cfg.color) + [1.0])

  def check_scene(self, mj_model) -> None:
    """The compiled scene holds this terrain's geom named `terrain`: a
    plane, or a heightfield of the generator's raster size."""
    names = names_of(mj_model, 'geom', mj_model.ngeom)
    want = GeomType.PLANE if self.generator is None else GeomType.HFIELD
    if 'terrain' not in names or int(
        mj_model.geom_type[names.index('terrain')]) != int(want):
      raise ValueError(f'the compiled scene has no {want.name.lower()} geom '
                       "named 'terrain'")
    if self.generator is not None:
      nx, ny = self.generator.raster.shape
      if mj_model.nhfield != 1 or (int(mj_model.hfield_nrow[0]),
                                   int(mj_model.hfield_ncol[0])) != (ny, nx):
        raise ValueError(
            f'the compiled scene\'s heightfield is not the generator\'s '
            f'{ny} x {nx} raster')

  @property
  def origins_table(self) -> 'np.ndarray | None':
    """(num_levels, num_types, 3) spawn-origin table of a generator
    terrain (None for the plane), read by the terrain-level curriculum."""
    return None if self.generator is None else self.generator.origins

  @property
  def max_level(self) -> int:
    return 1 if self.generator is None else self.generator.num_levels
