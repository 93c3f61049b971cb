"""The committed scene snapshots (asset_zoo.SNAPSHOTS), written through
the spec path.

    python -m mjlab_torch.scene.snapshot [TASK ...]

composes each task's scene from its cfgs (scene/scene.py), writes the
task's MujocoCfg options into the spec, compiles it once and writes the
snapshot, which records the scene's spec inputs; without a task it writes
every snapshot. Needs mujoco. Building the G1 tracking cfg writes its
default motion clip on first use.
"""

from __future__ import annotations

import sys

from mjlab_torch.asset_zoo import SNAPSHOTS


def _cfg(task: str):
  import mjlab_torch.tasks.velocity.config.tiny  # noqa: F401 (registers)
  from mjlab_torch.tasks import registry
  return registry.load_cfg(task)


def model(task: str):
  """The task's scene composed and compiled (a mujoco.MjModel)."""
  from mjlab_torch.scene.scene import compile_scene
  cfg = _cfg(task)
  return compile_scene(cfg.scene, cfg.sim.mujoco)


def snapshot(task: str):
  """The snapshot of the task's compiled scene, with its spec inputs."""
  from mjlab_torch.scene.scene import scene_snapshot
  cfg = _cfg(task)
  return scene_snapshot(cfg.scene, cfg.sim.mujoco)


def main(argv=None) -> None:
  tasks = list(sys.argv[1:] if argv is None else argv) or sorted(SNAPSHOTS)
  for task in tasks:
    snapshot(task).save(SNAPSHOTS[task])
    print(f'wrote {SNAPSHOTS[task]} ({task})')


if __name__ == '__main__':
  main()
