"""The compiled scenes of the configured tasks.

`g1_flat_arrays()` loads the G1 flat velocity scene from its pinned copy
(benchmark/reference/data/g1_flat_model.npz, the port's committed snapshot
as the benchmark was defined), so that the reference builds its Model
without the mujoco package and from no file of the port. The rough scene
puts a heightfield into it (rough_scene.py).
"""

from pathlib import Path

# the pinned copies of the raw snapshots (benchmark/reference/data)
DATA = Path(__file__).resolve().parents[2] / 'data'
G1_FLAT = DATA / 'g1_flat_model.npz'


def g1_flat_arrays():
  """The G1 flat scene's snapshot (a ModelArrays)."""
  from mjref.physics.io import ModelArrays
  return ModelArrays.load(G1_FLAT)
