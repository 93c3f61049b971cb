"""Robot descriptions and scene builders of the port.

`g1_flat_arrays()`, `go1_flat_arrays()`, `tracking_arrays()` and
`tiny_flat_arrays()` load the committed snapshots of the compiled Unitree
G1 and Go1 flat velocity scenes, of the G1 tracking scene and of the
TinyBot flat scene (data/g1_flat_model.npz, data/go1_flat_model.npz,
data/g1_tracking_model.npz and data/tiny_flat_model.npz, written by
`python -m mjlab_torch.asset_zoo.g1_flat_scene`, `... .go1_flat_scene`,
`... .g1_tracking_scene` and `... .tiny_scene`), so hosts without the
mujoco package can build the engine's Model; tests check each against a
fresh compile.
"""

from pathlib import Path

G1_FLAT_SNAPSHOT = Path(__file__).parent / 'data' / 'g1_flat_model.npz'
GO1_FLAT_SNAPSHOT = Path(__file__).parent / 'data' / 'go1_flat_model.npz'
G1_TRACKING_SNAPSHOT = (Path(__file__).parent / 'data'
                        / 'g1_tracking_model.npz')
TINY_FLAT_SNAPSHOT = Path(__file__).parent / 'data' / 'tiny_flat_model.npz'


def g1_flat_arrays():
  """The compiled G1 flat scene as a ModelArrays snapshot."""
  from mjlab_torch.physics.io import ModelArrays
  return ModelArrays.load(G1_FLAT_SNAPSHOT)


def go1_flat_arrays():
  """The compiled Go1 flat scene as a ModelArrays snapshot."""
  from mjlab_torch.physics.io import ModelArrays
  return ModelArrays.load(GO1_FLAT_SNAPSHOT)


def tracking_arrays():
  """The compiled G1 tracking scene as a ModelArrays snapshot."""
  from mjlab_torch.physics.io import ModelArrays
  return ModelArrays.load(G1_TRACKING_SNAPSHOT)


def tiny_flat_arrays():
  """The compiled TinyBot flat scene as a ModelArrays snapshot."""
  from mjlab_torch.physics.io import ModelArrays
  return ModelArrays.load(TINY_FLAT_SNAPSHOT)
