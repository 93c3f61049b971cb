"""Scene: the compiled model, the engine Model and the entity views.

Counterpart of mjlab_tpu/scene/scene.py. There the scene composes MjSpecs
and compiles them; the port takes the compiled scene (a `mujoco.MjModel`,
or its `ModelArrays` snapshot such as the committed G1 flat scene, which
needs no mujoco package), builds the engine `Model` on one device and one
`EntityView` per entity, and gives the terrain's `env_origins` (while the
terrain-level curriculum runs, the env's context reads the per-env origins
in its state instead). Everything dynamic lives in the batched `Data`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mjlab_torch.entity.entity import EntityCfg, EntityView
from mjlab_torch.physics import io as phys_io
from mjlab_torch.physics.tables import table
from mjlab_torch.physics.types import Model
from mjlab_torch.terrains.importer import (
    TerrainImporter,
    TerrainImporterCfg,
    grid_origins,
)


@dataclasses.dataclass
class SceneCfg:
  num_envs: int = 1
  env_spacing: float = 2.0
  terrain: 'TerrainImporterCfg | None' = None
  entities: 'dict[str, EntityCfg]' = dataclasses.field(default_factory=dict)
  # the compiled scene, when the caller hands the Scene none: terrain plus
  # each entity under the prefix `<name>/`. For a generator terrain it is
  # called with the terrain's TerrainGenerator, whose heightfield it holds
  model_fn: 'Callable | None' = None


class Scene:
  """`env_rows`: one rank's slice of a sharded env's `cfg.num_envs` envs
  (parallel/sharding.py); the scene then holds those envs, with the origins
  of the global env's rows."""

  def __init__(self, cfg: SceneCfg, mj_model=None, device='cuda',
               dtype=torch.float32, env_rows: 'slice | None' = None):
    self.cfg = cfg
    self._rows = slice(0, cfg.num_envs) if env_rows is None else env_rows
    self.num_envs = self._rows.stop - self._rows.start
    self.device = phys_io.resolve_device(device)
    self._dtype = dtype
    self.terrain = None
    if cfg.terrain is not None:
      self.terrain = TerrainImporter(cfg.terrain, cfg.num_envs, self._rows)
    gen = None if self.terrain is None else self.terrain.generator
    if mj_model is None:
      if cfg.model_fn is None:
        raise ValueError('Scene needs a compiled model: pass mj_model or '
                         'set SceneCfg.model_fn')
      mj_model = cfg.model_fn() if gen is None else cfg.model_fn(gen)
    if self.terrain is not None:
      self.terrain.check_scene(mj_model)
    self.mj_model = mj_model
    self.entities = dict(cfg.entities)
    self._views: 'dict[str, EntityView]' = {}
    self._model: 'Model | None' = None

  def initialize(self, ncon_cap: 'int | None' = None) -> Model:
    """Build the engine Model and the entity views.

    ncon_cap: per-env active-contact capacity (see physics.io.put_model)."""
    self._model = phys_io.put_model(self.mj_model, device=self.device,
                                    dtype=self._dtype, ncon_cap=ncon_cap)
    for name, ecfg in self.entities.items():
      self._views[name] = EntityView(ecfg, self.mj_model, f'{name}/',
                                     device=self.device, dtype=self._dtype)
    return self._model

  @property
  def model(self) -> Model:
    if self._model is None:
      raise RuntimeError('Scene.initialize() not called')
    return self._model

  def __getitem__(self, name: str) -> EntityView:
    if name not in self._views:
      raise KeyError(
          f'entity {name!r} not in scene; available: {list(self._views)}')
    return self._views[name]

  @property
  def env_origins(self) -> torch.Tensor:
    """(num_envs, 3) spawn origins from the terrain, or a square grid."""
    origins = (self.terrain.env_origins if self.terrain is not None
               else grid_origins(self.cfg.num_envs,
                                 self.cfg.env_spacing)[self._rows])
    return table(origins, self._dtype, self.device)
