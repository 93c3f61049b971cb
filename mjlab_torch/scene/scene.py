"""Scene: terrain + entities -> one compiled model, the engine Model and the
entity views.

Counterpart of mjlab_tpu/scene/scene.py. A scene is composed from its cfgs
(`compose_spec`): a base spec (skybox and headlight), the terrain built
into it (terrains/importer.py), and each entity's spec (entity/entity.py:
`spec_fn`, actuators, spec editors, the `init_state` keyframe) attached
under the prefix `<name>/`; the env writes its MujocoCfg's options in and
compiles once. That needs the mujoco package, which a GPU host lacks.

The committed snapshots are a cache of that route. Each records the spec
inputs of its scene (`spec_inputs`: the terrain cfg and, for each entity,
its name, `spec_fn`'s module and qualname, its init_state, actuators and
spec editors, each as its dataclass repr) and their digest. `Scene` loads
the snapshot that `SceneCfg.model_fn` returns only when its recorded
inputs are the cfg's; otherwise it composes the scene from the cfgs, and
on a host without mujoco it raises, naming both digests and the first
input that differs. So an edited cfg never runs on the registered model.
A compiled model passed as `mj_model=` is taken as it is.

What the digest does not see: anything the cfgs name but do not hold. An
edited robot data table (asset_zoo/data/*_spec_data.py), mesh pack or
`spec_fn` body keeps the digest; rewrite the snapshots after such an edit
(`python -m mjlab_torch.scene.snapshot`). MujocoCfg is not a spec
input either: the env writes it into the spec or the snapshot alike.

After the compile everything dynamic lives in the batched `Data`; the
scene gives the terrain's `env_origins` (while the terrain-level curriculum
runs, the env's context reads the per-env origins in its state instead).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable

import torch

from mjlab_torch.entity.entity import Entity, EntityCfg, EntityView
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
  # the committed snapshot of this scene (a ModelArrays that records its
  # spec inputs), taken when its inputs are the cfg's. For a generator
  # terrain it is called with the terrain's TerrainGenerator, whose
  # heightfield it holds
  model_fn: 'Callable | None' = None


def _callable_id(fn) -> str:
  if fn is None:
    return 'None'
  if isinstance(fn, functools.partial):
    return f'partial({_callable_id(fn.func)}, {fn.args!r}, {fn.keywords!r})'
  return f'{fn.__module__}.{fn.__qualname__}'


def terrain_input(terrain: 'TerrainImporterCfg | None') -> str:
  """The spec input of a terrain cfg: what the terrain builds into the
  spec (its env spacing only lays out origins)."""
  if terrain is None:
    return 'terrain: none'
  if terrain.terrain_type == 'generator':
    return f'terrain: generator {terrain.terrain_generator!r}'
  return f'terrain: {terrain.terrain_type} color={tuple(terrain.color)!r}'


def spec_inputs(cfg: SceneCfg) -> 'tuple[str, ...]':
  """What defines the scene's MjSpec, one line an input, in order: the
  terrain's first, then each entity's."""
  out = [terrain_input(cfg.terrain)]
  for name, e in cfg.entities.items():
    out.append(f'entity {name}: spec_fn {_callable_id(e.spec_fn)}')
    out.append(f'entity {name}: init_state {e.init_state!r}')
    out += [f'entity {name}: actuator {a!r}' for a in e.actuators]
    out += [f'entity {name}: editor {s!r}' for s in e.spec_editors]
  return tuple(out)


def with_terrain(inputs, terrain: 'TerrainImporterCfg | None'
                 ) -> 'tuple[str, ...]':
  """A scene's spec inputs with `terrain` in place of its terrain's."""
  return (terrain_input(terrain),) + tuple(
      i for i in inputs if not i.startswith('terrain: '))


def spec_digest(inputs) -> str:
  """The digest of a scene's spec inputs."""
  return hashlib.sha256('\n'.join(inputs).encode()).hexdigest()[:16]


def recording(arrays: phys_io.ModelArrays, inputs) -> phys_io.ModelArrays:
  """The snapshot `arrays` recording the spec inputs `inputs` and their
  digest."""
  return arrays.with_spec_inputs(inputs, spec_digest(inputs))


def _base_spec():
  """Sky and headlight, no geometry: the terrain and entities add the
  rest."""
  import mujoco
  spec = mujoco.MjSpec()
  spec.stat.extent = 4.0
  spec.visual.headlight.diffuse = (0.6, 0.6, 0.6)
  spec.visual.headlight.ambient = (0.3, 0.3, 0.3)
  spec.visual.headlight.specular = (0.0, 0.0, 0.0)
  spec.add_texture(
      name='skybox', type=mujoco.mjtTexture.mjTEXTURE_SKYBOX,
      builtin=mujoco.mjtBuiltin.mjBUILTIN_GRADIENT,
      rgb1=(0.3, 0.5, 0.7), rgb2=(0.0, 0.0, 0.0), width=512, height=3072)
  return spec


def compose_spec(cfg: SceneCfg, terrain: 'TerrainImporter | None' = None):
  """The scene's MjSpec composed from its cfgs (needs mujoco): the base
  spec, the terrain built in place (`terrain`, else one made from
  cfg.terrain), each entity attached under `<name>/`."""
  spec = _base_spec()
  if terrain is not None:
    terrain.build(spec)
  elif cfg.terrain is not None:
    TerrainImporter(cfg.terrain, cfg.num_envs, spec=spec)
  for name, ecfg in cfg.entities.items():
    frame = spec.worldbody.add_frame()
    spec.attach(Entity(ecfg).spec, prefix=f'{name}/', frame=frame)
  return spec


def compile_scene(cfg: SceneCfg, mujoco_cfg=None):
  """The compiled scene (a mujoco.MjModel) with `mujoco_cfg`'s options."""
  spec = compose_spec(cfg)
  if mujoco_cfg is not None:
    mujoco_cfg.edit_spec(spec)
  return spec.compile()


def scene_snapshot(cfg: SceneCfg, mujoco_cfg=None) -> phys_io.ModelArrays:
  """The snapshot of the compiled scene, recording its spec inputs."""
  return recording(phys_io.ModelArrays.of(compile_scene(cfg, mujoco_cfg)),
                   spec_inputs(cfg))


def _first_difference(want, got) -> str:
  for i in range(max(len(want), len(got))):
    w = want[i] if i < len(want) else '(none)'
    g = got[i] if i < len(got) else '(none)'
    if w != g:
      return f'input {i}: the cfg has {w!r}, the snapshot {g!r}'
  return 'none'


class Scene:
  """The scene of a SceneCfg on one device: the compiled model by the
  route rule (the module's docstring), the engine Model, one EntityView an
  entity and the env origins.

  `env_rows`: one rank's slice of a sharded env's `cfg.num_envs` envs
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
    self.spec_inputs = spec_inputs(cfg)
    self.digest = spec_digest(self.spec_inputs)
    # the MjSpec while the scene is composed and not yet compiled
    self.spec = None
    if mj_model is None:
      mj_model = self._snapshot()
    if mj_model is None:
      self.spec = compose_spec(cfg, self.terrain)
    else:
      self._check(mj_model)
    self._mj_model = mj_model
    self._compiled = None  # the spec path's MjModel of a snapshot scene
    self.entities = dict(cfg.entities)
    self._views: 'dict[str, EntityView]' = {}
    self._model: 'Model | None' = None

  def _snapshot(self):
    """model_fn's snapshot when it records the cfg's spec inputs; None
    where the scene is to be composed instead."""
    cfg = self.cfg
    if cfg.model_fn is None:
      return None
    gen = None if self.terrain is None else self.terrain.generator
    snap = cfg.model_fn() if gen is None else cfg.model_fn(gen)
    got = getattr(snap, 'spec_inputs', None)  # None: an MjModel
    if got == self.spec_inputs:
      return snap
    try:
      import mujoco  # noqa: F401
    except ImportError:
      got_digest = 'none' if got is None else spec_digest(got)
      raise RuntimeError(
          f'the scene of this cfg (spec digest {self.digest}) is not the '
          f'snapshot {_callable_id(cfg.model_fn)} loads (spec digest '
          f'{got_digest}; first difference: '
          f'{_first_difference(self.spec_inputs, got or ())}), and '
          'composing it from its cfgs needs the mujoco package') from None
    return None

  def _check(self, mj_model) -> None:
    if self.terrain is not None:
      self.terrain.check_scene(mj_model)

  @property
  def composed(self) -> bool:
    """Whether the scene was composed from its cfgs (not a snapshot)."""
    return self.spec is not None

  @property
  def mj_model(self):
    """The compiled scene; a composed scene compiles on the first read."""
    if self._mj_model is None:
      self._mj_model = self.spec.compile()
      self._check(self._mj_model)
    return self._mj_model

  def compiled(self, mujoco_cfg=None):
    """The scene as a compiled mujoco.MjModel, for drawing (needs mujoco:
    raises ImportError without it). A scene that holds one returns it; a
    snapshot scene composes its cfgs and compiles them with `mujoco_cfg`'s
    options once (the model its snapshot caches, by the route rule), then
    returns that model."""
    import mujoco
    if isinstance(self.mj_model, mujoco.MjModel):
      return self.mj_model
    if self._compiled is None:
      self._compiled = compile_scene(self.cfg, mujoco_cfg)
    return self._compiled

  def apply_options(self, mujoco_cfg) -> None:
    """Write the solver and integrator options in: into the spec of a
    scene not yet compiled, else into a copy of the compiled model."""
    if self._mj_model is None:
      mujoco_cfg.edit_spec(self.spec)
    else:
      self._mj_model = mujoco_cfg.apply(self._mj_model)

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
               else grid_origins(self.cfg.num_envs,
                                 self.cfg.env_spacing)[self._rows])
    return table(origins, self._dtype, self.device)
