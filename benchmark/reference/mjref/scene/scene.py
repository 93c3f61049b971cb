"""Scene: terrain + entities -> the engine Model and the entity views.

Counterpart of mjlab_tpu/scene/scene.py on its snapshot route: the
compiled scene is the ModelArrays that `SceneCfg.model_fn` loads (the
pinned snapshot under benchmark/reference/data, with a generator
terrain's heightfield put in), checked against the terrain. The spec
route, which composes the scene from its cfgs with the mujoco package, is
not copied: the configurations run on their snapshots.

After the compile everything dynamic lives in the batched `Data`; the
scene gives the terrain's `env_origins` (while the terrain-level curriculum
runs, the env's context reads the per-env origins in its state instead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from mjref.entity.entity import EntityCfg, EntityView
from mjref.physics import io as phys_io
from mjref.physics.tables import table
from mjref.physics.types import Model
from mjref.terrains.importer import (
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
  # the snapshot of this scene (a ModelArrays). For a generator terrain
  # it is called with the terrain's TerrainGenerator, whose heightfield it
  # holds
  model_fn: 'Callable | None' = None


class Scene:
  """The scene of a SceneCfg on one device: the compiled model (`mj_model`,
  else the snapshot of `cfg.model_fn`), the engine Model, one EntityView
  an entity and the env origins."""

  def __init__(self, cfg: SceneCfg, mj_model=None, device='cuda',
               dtype=torch.float32):
    self.cfg = cfg
    self.num_envs = cfg.num_envs
    self.device = phys_io.resolve_device(device)
    self._dtype = dtype
    self.terrain = None
    if cfg.terrain is not None:
      self.terrain = TerrainImporter(cfg.terrain, cfg.num_envs)
    if mj_model is None:
      gen = None if self.terrain is None else self.terrain.generator
      mj_model = cfg.model_fn() if gen is None else cfg.model_fn(gen)
    if self.terrain is not None:
      self.terrain.check_scene(mj_model)
    self.mj_model = mj_model
    self.entities = dict(cfg.entities)
    self._views: 'dict[str, EntityView]' = {}
    self._model: 'Model | None' = None

  def apply_options(self, mujoco_cfg) -> None:
    """Write the solver and integrator options into a copy of the
    compiled model."""
    self.mj_model = mujoco_cfg.apply(self.mj_model)

  def initialize(self, ncon_cap: 'int | None' = None) -> Model:
    """Build the engine Model and the entity views.

    ncon_cap: per-env active-contact capacity (see physics.io.put_model)."""
    mj = self.mj_model
    self._model = phys_io.put_model(mj, device=self.device,
                                    dtype=self._dtype, ncon_cap=ncon_cap)
    for name, ecfg in self.entities.items():
      self._views[name] = EntityView(ecfg, mj, f'{name}/',
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
               else grid_origins(self.cfg.num_envs, self.cfg.env_spacing))
    return table(origins, self._dtype, self.device)
