"""Robot descriptions and scene snapshots of the port.

`SNAPSHOTS` names the committed snapshot of each task whose compiled scene
is kept under data/: the Unitree G1 and Go1 flat velocity scenes, the G1
tracking scene and the TinyBot flat scene. The other tasks share one of
these scenes (the Play variants, the tracking variants, the Tiny tracking
task) or put a heightfield into one (rough_scene.py). `arrays(task)` loads
a snapshot, so hosts without the mujoco package can build the engine's
Model; `g1_flat_arrays()`, `go1_flat_arrays()`, `tracking_arrays()` and
`tiny_flat_arrays()` are the tasks' `SceneCfg.model_fn`. Each snapshot
records the spec inputs of its task's scene, and a Scene takes it only for
a cfg with the same inputs. `python -m mjlab_torch.scene.snapshot` rewrites
them through the spec path of scene/scene.py; tests check each against a
fresh compile. `oracle_models.oracle_arrays(name)` loads the engine's
oracle models of equality constraints, tendons and sensors the same way.
"""

from pathlib import Path

DATA = Path(__file__).parent / 'data'
G1_FLAT = 'Mjlab-Velocity-Flat-Unitree-G1'
GO1_FLAT = 'Mjlab-Velocity-Flat-Unitree-Go1'
G1_TRACKING = 'Mjlab-Tracking-Flat-Unitree-G1'
TINY_FLAT = 'Mjlab-Velocity-Flat-Tiny'
SNAPSHOTS = {
    G1_FLAT: DATA / 'g1_flat_model.npz',
    GO1_FLAT: DATA / 'go1_flat_model.npz',
    G1_TRACKING: DATA / 'g1_tracking_model.npz',
    TINY_FLAT: DATA / 'tiny_flat_model.npz',
}


def arrays(task: str):
  """The committed snapshot of the task's compiled scene (a ModelArrays)."""
  from mjlab_torch.physics.io import ModelArrays
  return ModelArrays.load(SNAPSHOTS[task])


def g1_flat_arrays():
  return arrays(G1_FLAT)


def go1_flat_arrays():
  return arrays(GO1_FLAT)


def tracking_arrays():
  return arrays(G1_TRACKING)


def tiny_flat_arrays():
  return arrays(TINY_FLAT)
