"""The Unitree G1, Go1 and TinyBot rough-terrain velocity scenes.

Builds the physics models the tasks `Mjlab-Velocity-Rough-Unitree-G1`,
`-Go1` and `Mjlab-Velocity-Rough-Tiny` build (mjlab_tpu/tasks/velocity/
config/{g1,go1}/rough_env_cfg.py, .../config/tiny.py): each robot's flat
scene (the committed snapshots of asset_zoo.SNAPSHOTS) with the terrain
generator's heightfield geom, named `terrain`, in place of the plane. The
foot ground-contact sensors filter on that name, so they see the
heightfield.

The heightfield is no committed file (the registered grid is 1200 x 2000
samples): `rough_scene_arrays` regenerates it from the generator's seed and
puts it into a flat scene's snapshot, so a host without mujoco builds the
scene (the snapshot then records the generator's terrain among its spec
inputs, so the rough cfg's inputs agree with it where its robot's agree
with the flat scene's); `g1_rough_model` and `go1_rough_model` compose
and compile the same scene through scene/scene.py on a host with mujoco,
and tests hold the two equal.
"""

from __future__ import annotations

import numpy as np

from mjlab_torch.physics.io import ModelArrays, names_of
from mjlab_torch.physics.types import GeomType
from mjlab_torch.scene.scene import recording, with_terrain
from mjlab_torch.terrains.generator import TerrainGenerator, hfield_geom_size
from mjlab_torch.terrains.importer import TerrainImporterCfg


def rough_scene_arrays(flat: ModelArrays,
                       generator: TerrainGenerator) -> ModelArrays:
  """The snapshot of `flat` (a scene whose geom `terrain` is a plane) with
  the generator's heightfield in place of the plane: the hfield asset and
  every field of the terrain geom that the compile changes (type, size,
  pos, rgba). Other names keep their ids."""
  a = flat.arrays()
  g = names_of(flat, 'geom', flat.ngeom).index('terrain')
  if int(a['geom_type'][g]) != int(GeomType.PLANE) or flat.nhfield:
    raise ValueError("the flat scene's 'terrain' geom is not a plane")
  hf = generator.hfield()
  edits = {'geom_type': int(GeomType.HFIELD),
           'geom_size': hfield_geom_size(hf.size),
           'geom_pos': hf.geom_pos, 'geom_rgba': hf.rgba}
  for k, v in edits.items():
    a[k] = a[k].copy()
    a[k][g] = v
  a['nhfield'] = np.asarray(1, a['nhfield'].dtype)
  a['hfield_nrow'] = np.array([hf.nrow], np.int32)
  a['hfield_ncol'] = np.array([hf.ncol], np.int32)
  a['hfield_size'] = hf.size[None].copy()
  a['hfield_data'] = hf.data.reshape(-1)
  out = ModelArrays(a)
  if flat.spec_inputs is not None:
    terrain = TerrainImporterCfg(terrain_type='generator',
                                 terrain_generator=generator.cfg)
    out = recording(out, with_terrain(flat.spec_inputs, terrain))
  return out


def g1_rough_arrays(generator: TerrainGenerator) -> ModelArrays:
  """The compiled G1 rough scene on the generator's terrain, from the
  committed G1 flat snapshot."""
  from mjlab_torch.asset_zoo import g1_flat_arrays
  return rough_scene_arrays(g1_flat_arrays(), generator)


def _rough_model(env_cfg, generator: TerrainGenerator):
  """The rough scene of a task cfg on the generator's terrain, composed
  and compiled (needs mujoco)."""
  from mjlab_torch.scene.scene import compile_scene
  env_cfg.scene.terrain.terrain_generator = generator.cfg
  return compile_scene(env_cfg.scene, env_cfg.sim.mujoco)


def g1_rough_model(generator: TerrainGenerator):
  """The G1 rough scene composed and compiled (needs mujoco)."""
  from mjlab_torch.tasks.velocity.config.g1.rough_env_cfg import (
      UnitreeG1RoughEnvCfg,
  )
  return _rough_model(UnitreeG1RoughEnvCfg(), generator)


def go1_rough_arrays(generator: TerrainGenerator) -> ModelArrays:
  """The compiled Go1 rough scene on the generator's terrain, from the
  committed Go1 flat snapshot."""
  from mjlab_torch.asset_zoo import go1_flat_arrays
  return rough_scene_arrays(go1_flat_arrays(), generator)


def go1_rough_model(generator: TerrainGenerator):
  """The Go1 rough scene composed and compiled (needs mujoco)."""
  from mjlab_torch.tasks.velocity.config.go1.rough_env_cfg import (
      UnitreeGo1RoughEnvCfg,
  )
  return _rough_model(UnitreeGo1RoughEnvCfg(), generator)


def tiny_rough_arrays(generator: TerrainGenerator) -> ModelArrays:
  """The compiled TinyBot rough scene on the generator's terrain, from the
  committed TinyBot flat snapshot."""
  from mjlab_torch.asset_zoo import tiny_flat_arrays
  return rough_scene_arrays(tiny_flat_arrays(), generator)
