"""Offscreen rendering of device trajectories through CPU MuJoCo.

Counterpart of mjlab_tpu/viewer/offscreen.py. The batched state on the
card never meets a renderer: a qpos trajectory, copied to the host once, is
posed frame by frame on a CPU MjData and drawn with mujoco.Renderer, the
envs of a tile side by side, from a camera of the model. The model is the
scene's compiled mujoco.MjModel (`scene_mj_model`).

Where nothing can be drawn the trajectory is kept instead:
- without the mujoco package (a GPU host loads its scenes from snapshots
  and has none), as given, in `<path>.qpos.npy`;
- without a GL context, as the JAX function keeps it, (T, tile, nq) in
  `<path>.qpos.npy`;
- without imageio, the frames in `<path>.frames.npy`.
Each branch prints which cause it met and what it wrote. A failed GL
context is remembered for the process: on a host without a display a
second mujoco.Renderer after a failed one aborts the process.
"""

from __future__ import annotations

import numpy as np

# why each Renderer class could not be made in this process (the class is
# the key, so that a stand-in renderer is tried on its own)
_NO_GL: 'dict[type, str]' = {}


def scene_mj_model(env):
  """The compiled mujoco.MjModel of `env.scene` (needs mujoco: raises
  ImportError without it). A scene that holds a snapshot hands out the
  model of the spec path the snapshot caches, compiled once with the env's
  MujocoCfg (scene/scene.py: `Scene.compiled`); any other scene is taken
  to hold its compiled model as `mj_model`."""
  scene = env.scene
  if hasattr(scene, 'compiled'):
    sim = getattr(getattr(env, 'cfg', None), 'sim', None)
    return scene.compiled(getattr(sim, 'mujoco', None))
  import mujoco
  if not isinstance(scene.mj_model, mujoco.MjModel):
    raise TypeError(f'the scene holds a {type(scene.mj_model).__name__}, '
                    'not a compiled mujoco.MjModel')
  return scene.mj_model


def render_trajectory(env, qpos_traj, path: str, height: int = 480,
                      width: int = 640, camera: 'str | int' = -1,
                      fps: 'int | None' = None) -> str:
  """Draw `qpos_traj`, (T, nq) of one env or (T, tile, nq) of a tile of
  envs side by side, into the video `path` (through imageio, at `fps`,
  by default the env's control rate). Returns the path of what it wrote:
  `path`, or the file a fallback of the module's docstring wrote."""
  qpos_traj = np.asarray(qpos_traj)
  try:
    mj = scene_mj_model(env)
  except ImportError as e:
    np.save(path + '.qpos.npy', qpos_traj)
    print(f'[viewer] no mujoco to draw with ({e}); dumped the qpos '
          f'trajectory to {path}.qpos.npy', flush=True)
    return path + '.qpos.npy'
  import mujoco
  md = mujoco.MjData(mj)
  if qpos_traj.ndim == 2:
    qpos_traj = qpos_traj[:, None, :]
  tile = qpos_traj.shape[1]
  frames = []
  cause = _NO_GL.get(mujoco.Renderer)
  if cause is None:
    try:
      renderer = mujoco.Renderer(mj, height=height, width=width)
    except Exception as e:  # no GL context available
      cause = _NO_GL[mujoco.Renderer] = str(e)
  if cause is not None:
    np.save(path + '.qpos.npy', qpos_traj)
    print(f'[viewer] no GL renderer available ({cause}); dumped qpos '
          f'trajectory to {path}.qpos.npy', flush=True)
    return path + '.qpos.npy'
  for step_qpos in qpos_traj:
    row = []
    for e in range(tile):
      md.qpos[:] = step_qpos[e]
      mujoco.mj_forward(mj, md)
      renderer.update_scene(md, camera=camera)
      row.append(renderer.render().copy())
    frames.append(np.concatenate(row, axis=1) if tile > 1 else row[0])
  renderer.close()
  fps = fps or int(round(1.0 / env.step_dt))
  try:
    import imageio
    imageio.mimsave(path, frames, fps=fps)
  except ImportError:
    np.save(path + '.frames.npy', np.stack(frames))
    print(f'[viewer] imageio unavailable; dumped raw frames to '
          f'{path}.frames.npy', flush=True)
    return path + '.frames.npy'
  return path
