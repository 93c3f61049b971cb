"""Terrain generator: a grid of procedural sub-terrains -> one heightfield.

Counterpart of mjlab_tpu/terrains/generator.py: difficulty rises along the
rows (the curriculum axis), types are striped over the columns by
proportion, and a flat apron borders the grid. All cells rasterize into a
single heightfield, which the engine collides robot primitives against
with fixed-shape gathers (physics/collision.py).

`TerrainGenerator.hfield()` returns the heightfield as MuJoCo compiles the
asset, so no mujoco package is needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mjref.terrains.sub_terrains import SubTerrainCfg


@dataclasses.dataclass
class TerrainGeneratorCfg:
  size: tuple = (8.0, 8.0)  # sub-terrain cell size (meters)
  border_width: float = 3.0  # flat apron around the grid
  num_rows: int = 10  # difficulty levels (curriculum axis)
  num_cols: int = 20  # terrain-type axis
  horizontal_scale: float = 0.1  # raster resolution (meters/sample)
  curriculum: bool = True
  difficulty_range: tuple = (0.0, 1.0)
  sub_terrains: dict = dataclasses.field(default_factory=dict)
  seed: int = 0
  color: tuple = (0.2, 0.25, 0.3)
  add_lights: bool = False
  # fraction of rows an env may start at
  max_init_terrain_level_ratio: float = 0.5


@dataclasses.dataclass(frozen=True)
class CompiledHfield:
  """The heightfield asset and its geom as MuJoCo compiles them."""
  data: np.ndarray  # (nrow, ncol) float32 in [0, 1]; row = y, col = x
  size: np.ndarray  # (4,) radius_x, radius_y, elevation, base
  geom_pos: np.ndarray  # (3,) the geom sits at z = the raster's minimum
  rgba: np.ndarray  # (4,) float32

  @property
  def nrow(self) -> int:
    return self.data.shape[0]

  @property
  def ncol(self) -> int:
    return self.data.shape[1]


def hfield_geom_size(size: np.ndarray) -> np.ndarray:
  """geom_size of a geom on a heightfield of `size`, as MuJoCo compiles
  it."""
  return np.array([size[0], size[1], 0.5 * (0.5 * size[2] + size[3])])


class TerrainGenerator:
  """Builds the full elevation raster and the per-cell spawn origins from
  `cfg.seed`."""

  def __init__(self, cfg: TerrainGeneratorCfg):
    if not cfg.sub_terrains:
      raise ValueError('sub_terrains must not be empty')
    self.cfg = cfg
    rng = np.random.default_rng(cfg.seed)
    hs = cfg.horizontal_scale
    nxc = max(int(round(cfg.size[0] / hs)), 2)
    nyc = max(int(round(cfg.size[1] / hs)), 2)
    nb = int(round(cfg.border_width / hs))

    names = list(cfg.sub_terrains)
    props = np.array([cfg.sub_terrains[n].proportion for n in names], float)
    props = props / props.sum()
    cum = np.cumsum(props)
    for n in names:
      cfg.sub_terrains[n].size = tuple(cfg.size)

    nx = cfg.num_rows * nxc + 2 * nb
    ny = cfg.num_cols * nyc + 2 * nb
    ex = (nx - 1) * hs / 2  # raster half-extent (centered on world origin)
    ey = (ny - 1) * hs / 2
    raster = np.zeros((nx, ny))
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
    d_lo, d_hi = cfg.difficulty_range

    for r in range(cfg.num_rows):
      for c in range(cfg.num_cols):
        if cfg.curriculum:
          difficulty = d_lo + (r + rng.uniform()) / cfg.num_rows * \
              (d_hi - d_lo)
          t = int(np.searchsorted(cum, (c + 0.5) / cfg.num_cols))
        else:
          difficulty = rng.uniform(d_lo, d_hi)
          t = int(np.searchsorted(cum, rng.uniform()))
        t = min(t, len(names) - 1)
        sub: SubTerrainCfg = cfg.sub_terrains[names[t]]
        h, origin = sub.function(difficulty, rng, nxc, nyc, hs)
        x0 = nb + r * nxc
        y0 = nb + c * nyc
        raster[x0:x0 + nxc, y0:y0 + nyc] = h
        # cell-local origin -> world (raster centered on world origin)
        origins[r, c] = origin + np.array(
            [-ex + x0 * hs, -ey + y0 * hs, 0.0])

    self.raster = raster
    self.origins = origins
    self.extent_x = ex
    self.extent_y = ey

  @property
  def num_levels(self) -> int:
    return self.cfg.num_rows

  def hfield(self) -> CompiledHfield:
    """The heightfield as MuJoCo compiles the port's asset: the raster
    normalized to [0, 1] over elevation = max(hmax - hmin, 1e-3),
    transposed to MuJoCo's layout (nrow = y, ncol = x) in float32; size
    (extent_x, extent_y, elevation, 1); the geom at z = hmin."""
    h = self.raster
    hmin = float(h.min())
    elev = max(float(h.max()) - hmin, 1e-3)
    data = ((h - hmin) / elev).T.astype(np.float32)
    return CompiledHfield(
        data=np.ascontiguousarray(data),
        size=np.array([self.extent_x, self.extent_y, elev, 1.0]),
        geom_pos=np.array([0.0, 0.0, hmin]),
        rgba=np.array(list(self.cfg.color) + [1.0], np.float32))
