"""The Unitree G1 rough-terrain velocity scene.

Builds the physics model that `Mjlab-Velocity-Rough-Unitree-G1` builds
(mjlab_tpu/tasks/velocity/config/g1/rough_env_cfg.py): the G1 flat
scene's snapshot with the terrain generator's heightfield geom, named
`terrain`, in place of the plane. The foot ground-contact sensors filter
on that name, so they see the heightfield. The heightfield is no
committed file (the registered grid is 1200 x 2000 samples):
`rough_scene_arrays` regenerates it from the generator's seed.
"""

from __future__ import annotations

import numpy as np

from mjref.physics.io import ModelArrays, names_of
from mjref.physics.types import GeomType
from mjref.terrains.generator import TerrainGenerator, hfield_geom_size


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
  return ModelArrays(a)


def g1_rough_arrays(generator: TerrainGenerator) -> ModelArrays:
  """The compiled G1 rough scene on the generator's terrain, from the
  G1 flat snapshot."""
  from mjref.asset_zoo import g1_flat_arrays
  return rough_scene_arrays(g1_flat_arrays(), generator)
