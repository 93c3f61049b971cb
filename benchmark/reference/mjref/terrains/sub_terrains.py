"""Procedural sub-terrain library.

Counterpart of mjlab_tpu/terrains/sub_terrains.py (pure numpy, kept as the
port's own copy). Every sub-terrain renders to an elevation grid in
meters; the generator stitches the cells into one heightfield, which the
engine collides against natively (physics/collision.py), so the whole
rough-terrain grid costs a handful of static collision pairs (robot geoms
x one hfield geom).

Each cfg's `function(difficulty, rng, nx, ny, hs)` returns
(heights (nx, ny) meters, origin (3,) cell-local meters). nx/ny are the
sample counts along x/y, hs is the horizontal resolution in meters.
The z=0 plane is the cell's nominal ground level.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SubTerrainCfg:
  """Base sub-terrain."""
  proportion: float = 1.0
  size: tuple = (8.0, 8.0)  # set by the generator

  def function(self, difficulty: float, rng: np.random.Generator,
               nx: int, ny: int, hs: float):
    raise NotImplementedError


def _grid_xy(nx: int, ny: int, hs: float):
  """Sample coordinates: x[i], y[j] of the raster, cell-local (0..size)."""
  x = np.arange(nx) * hs
  y = np.arange(ny) * hs
  return x[:, None], y[None, :]


@dataclasses.dataclass
class BoxFlatTerrainCfg(SubTerrainCfg):
  """Flat cell (reference primitive_terrains.py:53-64)."""

  def function(self, difficulty, rng, nx, ny, hs):
    del difficulty, rng
    size = self.size
    return np.zeros((nx, ny)), np.array([size[0] / 2, size[1] / 2, 0.0])


# Alias matching the heightfield-native naming.
FlatTerrainCfg = BoxFlatTerrainCfg


@dataclasses.dataclass
class BoxPyramidStairsTerrainCfg(SubTerrainCfg):
  """Concentric stair rings ascending to a center platform
  (reference primitive_terrains.py:67-222). Ring k (from the outer edge)
  has top z = (k+1)*step_height; the platform sits one step above the
  last ring, so the spawn origin is at (num_steps+1)*step_height."""
  step_height_range: tuple = (0.05, 0.23)
  step_width: float = 0.3
  platform_width: float = 1.0
  border_width: float = 0.0
  inverted: bool = False

  def function(self, difficulty, rng, nx, ny, hs):
    del rng
    size = self.size
    lo, hi = self.step_height_range
    step_height = lo + difficulty * (hi - lo)
    num_steps_x = int((size[0] - 2 * self.border_width -
                       self.platform_width) // (2 * self.step_width))
    num_steps_y = int((size[1] - 2 * self.border_width -
                       self.platform_width) // (2 * self.step_width))
    num_steps = min(num_steps_x, num_steps_y)

    x, y = _grid_xy(nx, ny, hs)
    # distance inward from the border band
    dx = np.minimum(x - self.border_width, size[0] - self.border_width - x)
    dy = np.minimum(y - self.border_width, size[1] - self.border_width - y)
    d = np.minimum(dx, dy)
    ring = np.floor(d / self.step_width) + 1.0
    k = np.clip(ring, 0.0, num_steps + 1.0)
    k = np.where(d <= 0.0, 0.0, k)
    h = step_height * k * (-1.0 if self.inverted else 1.0)
    origin_z = (num_steps + 1) * step_height
    origin_z *= -1.0 if self.inverted else 1.0
    return h, np.array([size[0] / 2, size[1] / 2, origin_z])


@dataclasses.dataclass
class BoxInvertedPyramidStairsTerrainCfg(BoxPyramidStairsTerrainCfg):
  """Stairs descending into a pit (reference primitive_terrains.py:226)."""

  def __post_init__(self):
    self.inverted = True


@dataclasses.dataclass
class BoxRandomGridTerrainCfg(SubTerrainCfg):
  """Checkerboard of randomly raised/lowered square blocks with a flat
  spawn platform at the center (reference primitive_terrains.py:380+)."""
  grid_width: float = 0.45
  grid_height_range: tuple = (0.05, 0.2)
  platform_width: float = 1.0

  def function(self, difficulty, rng, nx, ny, hs):
    size = self.size
    lo, hi = self.grid_height_range
    gh = lo + difficulty * (hi - lo)
    ncell_x = max(int(size[0] // self.grid_width), 1)
    ncell_y = max(int(size[1] // self.grid_width), 1)
    cell_h = rng.uniform(-gh, gh, size=(ncell_x, ncell_y))
    x, y = _grid_xy(nx, ny, hs)
    ix = np.clip((x / self.grid_width).astype(int), 0, ncell_x - 1)
    iy = np.clip((y / self.grid_width).astype(int), 0, ncell_y - 1)
    h = cell_h[ix, iy] * np.ones((nx, ny))
    # flat platform at center
    half = self.platform_width / 2
    plat = (np.abs(x - size[0] / 2) <= half) & (np.abs(y - size[1] / 2) <= half)
    h = np.where(plat, 0.0, h)
    return h, np.array([size[0] / 2, size[1] / 2, 0.0])


@dataclasses.dataclass
class HfRandomUniformTerrainCfg(SubTerrainCfg):
  """Uniform-noise rough ground (reference heightfield_terrains.py
  HfRandomUniformTerrainCfg): noise sampled on a coarse grid at
  `downsampled_scale`, snapped to `noise_step`, bilinearly upsampled."""
  noise_range: tuple = (0.02, 0.1)
  noise_step: float = 0.02
  downsampled_scale: float | None = None
  border_width: float = 0.0

  def function(self, difficulty, rng, nx, ny, hs):
    size = self.size
    lo, hi = self.noise_range
    amp = lo + difficulty * (hi - lo)
    ds = self.downsampled_scale or max(hs, 0.2)
    cx = max(int(round(size[0] / ds)) + 1, 2)
    cy = max(int(round(size[1] / ds)) + 1, 2)
    coarse = rng.uniform(-amp, amp, size=(cx, cy))
    if self.noise_step > 0:
      coarse = np.round(coarse / self.noise_step) * self.noise_step
    # bilinear upsample to (nx, ny)
    xi = np.linspace(0, cx - 1, nx)
    yi = np.linspace(0, cy - 1, ny)
    x0 = np.clip(xi.astype(int), 0, cx - 2)
    y0 = np.clip(yi.astype(int), 0, cy - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    h = ((coarse[x0][:, y0] * (1 - fx) + coarse[x0 + 1][:, y0] * fx) *
         (1 - fy) +
         (coarse[x0][:, y0 + 1] * (1 - fx) + coarse[x0 + 1][:, y0 + 1] * fx)
         * fy)
    if self.border_width > 0:
      x, y = _grid_xy(nx, ny, hs)
      inb = ((x >= self.border_width) & (x <= size[0] - self.border_width) &
             (y >= self.border_width) & (y <= size[1] - self.border_width))
      h = np.where(inb, h, 0.0)
    return h, np.array([size[0] / 2, size[1] / 2, float(np.max(h))])


@dataclasses.dataclass
class HfPyramidSlopedTerrainCfg(SubTerrainCfg):
  """Cone slope rising (or sinking, inverted) to a center platform
  (reference heightfield_terrains.py HfPyramidSlopedTerrainCfg)."""
  slope_range: tuple = (0.0, 0.4)
  platform_width: float = 1.0
  border_width: float = 0.0
  inverted: bool = False

  def function(self, difficulty, rng, nx, ny, hs):
    del rng
    size = self.size
    lo, hi = self.slope_range
    slope = lo + difficulty * (hi - lo)
    x, y = _grid_xy(nx, ny, hs)
    dx = np.minimum(x - self.border_width, size[0] - self.border_width - x)
    dy = np.minimum(y - self.border_width, size[1] - self.border_width - y)
    d = np.clip(np.minimum(dx, dy), 0.0, None)
    half_extent = (min(size) - 2 * self.border_width - self.platform_width) / 2
    h = slope * np.minimum(d, half_extent)
    if self.inverted:
      h = -h
    oz = slope * half_extent * (-1.0 if self.inverted else 1.0)
    return h, np.array([size[0] / 2, size[1] / 2, oz])


@dataclasses.dataclass
class HfInvertedPyramidSlopedTerrainCfg(HfPyramidSlopedTerrainCfg):

  def __post_init__(self):
    self.inverted = True


@dataclasses.dataclass
class HfWaveTerrainCfg(SubTerrainCfg):
  """Sinusoidal waves (reference heightfield_terrains.py HfWaveTerrainCfg)."""
  amplitude_range: tuple = (0.0, 0.2)
  num_waves: int = 4
  border_width: float = 0.0

  def function(self, difficulty, rng, nx, ny, hs):
    del rng
    size = self.size
    lo, hi = self.amplitude_range
    amp = (lo + difficulty * (hi - lo)) / 2
    x, y = _grid_xy(nx, ny, hs)
    wx = 2 * np.pi * self.num_waves / size[0]
    wy = 2 * np.pi * self.num_waves / size[1]
    h = amp * (np.sin(wx * x) + np.cos(wy * y)) * np.ones((nx, ny))
    oz = float(amp * (np.sin(wx * size[0] / 2) + np.cos(wy * size[1] / 2)))
    return h, np.array([size[0] / 2, size[1] / 2, oz])
