"""The port's viewer stack (mjlab_torch/viewer) and the writers' add_video
against the JAX package's on the CPU: the primitive triangulations bit for
bit, the scene visualizer's ghost, render_trajectory through a stand-in
renderer (tiled and untiled), its no-GL, no-mujoco and no-imageio
branches, the BaseViewer's controls and run loop, the native viewer's key
bindings and perturbation write-back with a stand-in `launch_passive`,
play's --viewer, and the viser viewer with the fake viser of
tests/test_optional_deps.py. No
test here draws with a real GL context: on a host without a display a
second mujoco.Renderer after a failed one aborts the process."""

import sys
import types

import mujoco
import numpy as np
import pytest
import torch

from mjlab_torch.viewer import base as tbase
from mjlab_torch.viewer import debug_visualizer as tdv
from mjlab_torch.viewer import native as tnative
from mjlab_torch.viewer import offscreen as toff
from mjlab_torch.viewer import primitives as tprim
from mjlab_tpu.viewer import base as jbase
from mjlab_tpu.viewer import debug_visualizer as jdv
from mjlab_tpu.viewer import native as jnative
from mjlab_tpu.viewer import offscreen as joff
from mjlab_tpu.viewer import primitives as jprim

TET_XML = """
<mujoco>
  <asset>
    <mesh name="tet" vertex="0 0 0  1 0 0  0 1 0  0 0 1"/>
  </asset>
  <worldbody>
    <geom type="plane" size="1 1 0.1"/>
    <body><freejoint/>
      <geom type="mesh" mesh="tet" pos="0 0 1"/>
      <geom type="capsule" size="0.05 0.2" pos="0.3 0 1"/>
    </body>
  </worldbody>
</mujoco>"""


@pytest.fixture(scope='module')
def tet():
  return mujoco.MjModel.from_xml_string(TET_XML)


@pytest.fixture(scope='module')
def go1():
  from mjlab_tpu.asset_zoo.unitree_go1 import GO1_ROBOT_CFG
  from mjlab_tpu.entity.entity import Entity
  return Entity(GO1_ROBOT_CFG).spec.compile()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

G = mujoco.mjtGeom
PRIMITIVES = [
    ('uv_sphere', (0.3,), {}),
    ('uv_sphere', (0.2,), {'z_offset': 0.1, 'half': 'top'}),
    ('uv_sphere', (0.2,), {'z_offset': -0.1, 'half': 'bottom'}),
    ('cylinder_shell', (0.1, 0.3), {}),
    ('cylinder_shell', (0.1, 0.3), {'caps': False}),
    ('capsule_mesh', (0.05, 0.2), {}),
    ('box_mesh', ((0.1, 0.2, 0.3),), {}),
    ('arrow_mesh', (1.0, 0.02), {}),
    ('geom_mesh', (int(G.mjGEOM_SPHERE), [0.1, 0, 0]), {}),
    ('geom_mesh', (int(G.mjGEOM_CAPSULE), [0.05, 0.2, 0]), {}),
    ('geom_mesh', (int(G.mjGEOM_CYLINDER), [0.05, 0.2, 0]), {}),
    ('geom_mesh', (int(G.mjGEOM_BOX), [0.1, 0.1, 0.1]), {}),
    ('geom_mesh', (int(G.mjGEOM_ELLIPSOID), [0.1, 0.2, 0.3]), {}),
    ('geom_mesh', (int(G.mjGEOM_PLANE), [1.0, 1.0, 0.1]), {}),
    ('geom_mesh', (int(G.mjGEOM_PLANE), [0.0, 0.0, 0.1]), {}),
    ('geom_mesh', (int(G.mjGEOM_MESH), [0, 0, 0]), {}),
    ('geom_mesh', (int(G.mjGEOM_HFIELD), [1, 1, 0.1, 0.1]), {}),
]


@pytest.mark.parametrize('name,args,kw', PRIMITIVES,
                         ids=[f'{n}-{i}' for i, (n, _, _)
                              in enumerate(PRIMITIVES)])
def test_primitive_matches_jax_bit_for_bit(name, args, kw):
  got = getattr(tprim, name)(*args, **kw)
  want = getattr(jprim, name)(*args, **kw)
  if want is None:
    assert got is None
    return
  for g, w in zip(got, want):
    assert g.dtype == w.dtype
    np.testing.assert_array_equal(g, w)


def test_weld_vertices_matches_jax():
  v, f = jprim.capsule_mesh(0.05, 0.2)
  verts = np.concatenate([v, v + 1e-9])
  faces = np.concatenate([f, f + len(v)])
  for g, w in zip(tprim.weld_vertices(verts, faces),
                  jprim.weld_vertices(verts, faces)):
    np.testing.assert_array_equal(g, w)


def test_mujoco_mesh_matches_jax_on_the_tetrahedron(tet):
  meshes = 0
  for g in range(tet.ngeom):
    got, want = tprim.mujoco_mesh(tet, g), jprim.mujoco_mesh(tet, g)
    if want is None:
      assert got is None
      continue
    meshes += 1
    assert got[0].shape == (4, 3)
    for a, b in zip(got, want):
      assert a.dtype == b.dtype
      np.testing.assert_array_equal(a, b)
  assert meshes == 1


# ---------------------------------------------------------------------------
# the scene visualizer
# ---------------------------------------------------------------------------


def _scene_geoms(scn):
  return {k: np.array([getattr(scn.geoms[i], k) for i in range(scn.ngeom)])
          for k in ('type', 'size', 'pos', 'mat', 'rgba')}


def test_scene_visualizer_ghost_matches_jax(go1):
  kid = mujoco.mj_name2id(go1, mujoco.mjtObj.mjOBJ_KEY, 'init_state')
  qpos = go1.key_qpos[kid].copy()
  qpos[7:] += 0.1
  scenes = []
  for mod in (tdv, jdv):
    scn = mujoco.MjvScene(go1, maxgeom=200)
    vis = mod.MujocoSceneVisualizer(scn, go1)
    vis.clear()
    vis.add_ghost_qpos(qpos, alpha=0.4)
    vis.add_arrow([0, 0, 0], [0.1, 0.2, 1.0], color=(1, 0, 0, 1))
    vis.add_sphere([1, 0, 0], radius=0.07)
    scenes.append(scn)
  got, want = (_scene_geoms(s) for s in scenes)
  n_prims = sum(1 for g in range(go1.ngeom) if go1.geom_bodyid[g] != 0)
  assert scenes[0].ngeom == scenes[1].ngeom == n_prims + 2
  for k in got:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)
  tvis = tdv.MujocoSceneVisualizer(scenes[0], go1)
  tvis.clear()
  assert scenes[0].ngeom == 0
  null = tdv.NullVisualizer()
  null.add_arrow(0, 1)
  null.add_ghost_qpos(qpos)
  null.clear()


# ---------------------------------------------------------------------------
# render_trajectory
# ---------------------------------------------------------------------------


def _env(mj):
  """What render_trajectory reads of an env: a scene holding its compiled
  model, and the control step."""
  return types.SimpleNamespace(
      scene=types.SimpleNamespace(mj_model=mj), step_dt=0.02)


def _traj(mj, shape, seed=0):
  rng = np.random.default_rng(seed)
  q = np.tile(mj.qpos0, shape + (1,))
  q[..., :3] += 0.3 * rng.normal(size=shape + (3,))
  q[..., 3:7] += 0.1 * rng.normal(size=shape + (4,))
  q[..., 3:7] /= np.linalg.norm(q[..., 3:7], axis=-1, keepdims=True)
  return q


class _EncodingRenderer:
  """A stand-in mujoco.Renderer whose image encodes the posed geoms'
  world positions and the camera it was asked for."""

  def __init__(self, model, height=480, width=640):
    self.h, self.w = height, width

  def update_scene(self, data, camera=-1):
    self.xpos = data.geom_xpos.copy()
    self.camera = camera

  def render(self):
    img = np.zeros((self.h, self.w, 3), np.float64)
    flat = self.xpos.reshape(-1)
    img.reshape(-1)[:flat.size] = flat
    img[-1, -1, 0] = len(str(self.camera))
    return img

  def close(self):
    pass


class _NoGlRenderer:

  def __init__(self, *a, **k):
    raise RuntimeError('no GL context (stand-in)')


@pytest.mark.parametrize('shape,camera', [((5,), -1), ((4, 3), 'track')],
                         ids=['untiled', 'tiled'])
def test_render_trajectory_frames_match_jax(tet, tmp_path, monkeypatch,
                                            shape, camera):
  monkeypatch.setattr(mujoco, 'Renderer', _EncodingRenderer)
  monkeypatch.setitem(sys.modules, 'imageio', None)  # frames to .npy
  traj = _traj(tet, shape)
  got = toff.render_trajectory(_env(tet), traj, str(tmp_path / 't.mp4'),
                               height=24, width=32, camera=camera)
  joff.render_trajectory(_env(tet), traj, str(tmp_path / 'j.mp4'),
                         height=24, width=32, camera=camera)
  assert got == str(tmp_path / 't.mp4.frames.npy')
  frames = np.load(got)
  want = np.load(tmp_path / 'j.mp4.frames.npy')
  tile = 1 if len(shape) == 1 else shape[1]
  assert frames.shape == (shape[0], 24, 32 * tile, 3)
  np.testing.assert_array_equal(frames, want)
  assert np.abs(frames).max() > 0


def test_render_trajectory_writes_through_imageio(tet, tmp_path, monkeypatch):
  monkeypatch.setattr(mujoco, 'Renderer', _EncodingRenderer)
  saved = []
  fake = types.ModuleType('imageio')
  fake.mimsave = lambda path, frames, fps: saved.append((path, len(frames),
                                                         fps))
  monkeypatch.setitem(sys.modules, 'imageio', fake)
  path = str(tmp_path / 'v.mp4')
  assert toff.render_trajectory(_env(tet), _traj(tet, (3,)), path,
                                height=8, width=8) == path
  assert saved == [(path, 3, 50)]


def test_no_gl_branch_writes_the_jax_qpos(tet, tmp_path, monkeypatch):
  monkeypatch.setattr(mujoco, 'Renderer', _NoGlRenderer)
  for shape in ((6,), (6, 2)):
    traj = _traj(tet, shape, seed=1)
    got = toff.render_trajectory(_env(tet), traj, str(tmp_path / 't.mp4'))
    joff.render_trajectory(_env(tet), traj, str(tmp_path / 'j.mp4'))
    assert got == str(tmp_path / 't.mp4.qpos.npy')
    a, b = np.load(got), np.load(tmp_path / 'j.mp4.qpos.npy')
    assert a.shape == (6, 1 if len(shape) == 1 else 2, tet.nq)
    np.testing.assert_array_equal(a, b)
  # the failed renderer is not tried again in this process
  assert 'stand-in' in toff._NO_GL[_NoGlRenderer]


def test_without_mujoco_the_qpos_is_kept_and_the_cause_named(
    tet, tmp_path, monkeypatch, capsys):
  """The card's case: no mujoco at all, a registered task's scene (a
  snapshot) and a stand-in scene alike."""
  from mjlab_torch.scene.scene import Scene
  from mjlab_torch.tasks import registry
  cfg = registry.load_cfg('Mjlab-Velocity-Flat-Unitree-Go1')
  cfg.scene.num_envs = 1
  snap_env = types.SimpleNamespace(scene=Scene(cfg.scene, device='cpu'),
                                   cfg=cfg, step_dt=0.02)
  assert not snap_env.scene.composed
  monkeypatch.setitem(sys.modules, 'mujoco', None)
  for env, shape in ((_env(tet), (5,)), (snap_env, (4, 3))):
    traj = np.random.default_rng(2).normal(size=shape + (tet.nq,))
    path = str(tmp_path / f'{len(shape)}.mp4')
    got = toff.render_trajectory(env, traj, path)
    assert got == path + '.qpos.npy'
    np.testing.assert_array_equal(np.load(got), traj)  # as given
    assert 'no mujoco' in capsys.readouterr().out


def test_a_snapshot_scene_compiles_its_spec_path_once():
  from mjlab_torch.scene.scene import Scene, compile_scene
  from mjlab_torch.tasks import registry
  cfg = registry.load_cfg('Mjlab-Velocity-Flat-Unitree-Go1')
  cfg.scene.num_envs = 1
  scene = Scene(cfg.scene, device='cpu')
  env = types.SimpleNamespace(scene=scene, cfg=cfg)
  mj = toff.scene_mj_model(env)
  assert isinstance(mj, mujoco.MjModel) and toff.scene_mj_model(env) is mj
  want = compile_scene(cfg.scene, cfg.sim.mujoco)
  assert (mj.nq, mj.ngeom, mj.nbody) == (want.nq, want.ngeom, want.nbody)
  np.testing.assert_array_equal(mj.geom_size, want.geom_size)
  assert mj.nq == scene.mj_model.nq  # the snapshot's layout


# ---------------------------------------------------------------------------
# BaseViewer
# ---------------------------------------------------------------------------


class _CountingEnv:
  """An env of 3 that counts its resets and steps."""

  num_envs = 3

  def __init__(self):
    self.log = []

  def reset(self, seed=None):
    self.log.append('reset')
    return {'policy': len(self.log)}, {}

  def step(self, action):
    self.log.append(('step', action))
    return ({'policy': len(self.log)}, 0.0, False, False, {})


def _scripted(mod):
  """Drive a viewer of `mod` through pause, speed, env switching and a
  reset request over 6 frames; its env's calls and its stats after each
  control."""

  class Scripted(mod.BaseViewer):
    script = {1: 'toggle_pause', 2: 'toggle_pause', 3: 'request_reset',
              4: 'next_env'}

    def setup(self):
      self.frames = 0

    def sync_env_to_viewer(self):
      self.frames += 1
      name = self.script.get(self.frames)
      if name:
        getattr(self, name)()

    def is_running(self):
      return self.frames < 6

  env = _CountingEnv()
  v = Scripted(env, policy=lambda obs: obs['policy'], fps=1e6)
  stats = []
  for ctl in ('speed_down', 'speed_down', 'speed_up', 'prev_env', 'prev_env',
              'next_env', 'next_env', 'next_env', 'next_env'):
    getattr(v, ctl)()
    stats.append(dict(v.stats, sim_ms=None, render_ms=None))
  for _ in range(len(mod.SPEEDS) + 2):
    v.speed_up()
  v.run()
  v.close()
  return env.log, stats, v.env_index, v.is_running(), v.speed


def test_base_viewer_controls_and_loop_match_jax():
  assert tbase.SPEEDS == jbase.SPEEDS
  got, want = _scripted(tbase), _scripted(jbase)
  assert got == want
  log = got[0]
  # paused for one frame, a reset on request
  assert log.count('reset') == 2 and len(log) == 2 + 5
  t = tbase.Timer(window=2)
  for _ in range(3):
    t.tic()
    t.toc()
  assert len(t.samples) == 2 and t.mean_ms >= 0


# ---------------------------------------------------------------------------
# the native viewer
# ---------------------------------------------------------------------------


class _FakePassive:

  def __init__(self, mj, md, key_callback):
    self.user_scn = mujoco.MjvScene(mj, maxgeom=100)
    self.key_callback = key_callback
    self.syncs = 0
    self.closed = False

  def is_running(self):
    return not self.closed

  def sync(self):
    self.syncs += 1

  def close(self):
    self.closed = True


def _fake_launch(monkeypatch):
  made = []

  def launch_passive(mj, md, key_callback=None):
    made.append(_FakePassive(mj, md, key_callback))
    return made[-1]

  import mujoco.viewer
  monkeypatch.setattr(mujoco.viewer, 'launch_passive', launch_passive)
  return made


class _Arrows:
  """A command term that draws one arrow from env e's root."""

  def __init__(self, calls):
    self.calls = calls

  def debug_vis(self, state, env, env_index, vis):
    self.calls.append(env_index)
    vis.add_arrow([0, 0, 0], [0, 0, float(env_index) + 1])


def _native_env(tet, lib):
  n = 4
  qpos = np.tile(tet.qpos0, (n, 1)) + np.arange(n)[:, None] * 0.1
  qvel = np.ones((n, tet.nv)) * np.arange(n)[:, None]
  xfrc = np.zeros((n, tet.nbody, 6))
  if lib == 'torch':
    data = types.SimpleNamespace(qpos=torch.as_tensor(qpos),
                                 qvel=torch.as_tensor(qvel),
                                 xfrc_applied=torch.as_tensor(xfrc))
  else:
    import jax.numpy as jnp

    class _D(types.SimpleNamespace):
      def replace(self, **kw):
        return _D(**{**vars(self), **kw})

    class _S(types.SimpleNamespace):
      def replace(self, **kw):
        return _S(**{**vars(self), **kw})

    data = _D(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
              xfrc_applied=jnp.asarray(xfrc))
  calls = []
  env = types.SimpleNamespace(
      num_envs=n, scene=types.SimpleNamespace(mj_model=tet),
      command_manager=types.SimpleNamespace(terms={'twist': _Arrows(calls)}))
  state = (types.SimpleNamespace if lib == 'torch' else _S)(
      data=data, command={'twist': None})
  env._state = state
  return env, calls


def _state_prop(env_cls_env):
  """The stand-in env's `state` reads its `_state`, as the envs' do."""
  return type('Env', (types.SimpleNamespace,), {
      'state': property(lambda self: self._state)})(**vars(env_cls_env))


def test_native_viewer_keys_and_perturbation_write_back(tet, monkeypatch):
  made = _fake_launch(monkeypatch)
  viewers = {}
  for lib, mod in (('torch', tnative), ('jax', jnative)):
    env, calls = _native_env(tet, lib)
    env = _state_prop(env)
    v = mod.NativeMujocoViewer(env, policy=None)
    v.setup()
    viewers[lib] = (v, env, calls)
  assert len(made) == 2
  keys = [ord(']'), ord(']'), ord('['), ord('-'), ord('-'), ord('='),
          ord(' '), 259, ord('x')]
  for lib, (v, _, _) in viewers.items():
    states = []
    for k in keys:
      v._on_key(k)
      states.append((v.env_index, v.speed_idx, v.paused,
                     v.reset_requested))
    viewers[lib] += (states,)
  assert viewers['torch'][3] == viewers['jax'][3]
  assert viewers['torch'][3][-1] == (1, len(tbase.SPEEDS) - 2, True, True)

  v, env, calls = viewers['torch'][:3]
  v.env_index = 2
  v.sync_env_to_viewer()
  np.testing.assert_array_equal(v.md.qpos, env.state.data.qpos[2].numpy())
  np.testing.assert_array_equal(v.md.qvel, env.state.data.qvel[2].numpy())
  assert calls == [2] and v.debug_vis.scn.ngeom == 1
  assert made[0].syncs == 1
  # a GUI perturbation goes into env 2's row of the tensor, in place
  xfrc = env.state.data.xfrc_applied
  v.md.xfrc_applied[1] = [1.0, 2.0, 3.0, 0.1, 0.2, 0.3]
  v.sync_viewer_to_env()
  assert env.state.data.xfrc_applied is xfrc
  want = np.zeros_like(xfrc.numpy())
  want[2, 1] = [1.0, 2.0, 3.0, 0.1, 0.2, 0.3]
  np.testing.assert_array_equal(xfrc.numpy(), want)
  jv, jenv, _ = viewers['jax'][:3]
  jv.env_index = 2
  jv.md.xfrc_applied[1] = v.md.xfrc_applied[1]
  jv.sync_viewer_to_env()
  np.testing.assert_array_equal(np.asarray(jenv._state.data.xfrc_applied),
                                want)
  assert v.is_running()
  v.teardown()
  assert made[0].closed and not v.is_running()


def test_native_viewer_prints_a_failing_hook(tet, monkeypatch, capsys):
  _fake_launch(monkeypatch)
  env, _ = _native_env(tet, 'torch')
  env = _state_prop(env)

  class Broken:
    def debug_vis(self, *a):
      raise ValueError('boom')

  env.command_manager.terms['bad'] = Broken()
  env._state.command['bad'] = None
  v = tnative.NativeMujocoViewer(env, policy=None)
  v.setup()
  v.sync_env_to_viewer()
  assert "debug_vis(bad) failed: ValueError('boom')" in capsys.readouterr().out


class _ThreeFrames(_FakePassive):
  """A GUI window the user closes after three frames."""

  def is_running(self):
    return not self.closed and self.syncs < 3


@pytest.mark.parametrize('display', [':0', None], ids=['display', 'none'])
def test_play_viewer_flag(monkeypatch, tmp_path, display):
  """`play --viewer` opens the native viewer after the play where DISPLAY
  is set (a stand-in window closed after three frames: the policy steps
  the env under it), else the viser viewer, which names the missing
  viser."""
  import mujoco.viewer

  import mjlab_torch.tasks.velocity.config.tiny  # noqa: F401 (registers)
  from mjlab_torch.scripts import play
  argv = ['Mjlab-Velocity-Flat-Tiny', '--device', 'cpu', '--agent', 'zero',
          '--num-envs', '2', '--steps', '1', '--log-root', str(tmp_path),
          '--viewer']
  if display is None:
    monkeypatch.delenv('DISPLAY', raising=False)
    monkeypatch.setitem(sys.modules, 'viser', None)
    with pytest.raises(ImportError, match='optional `viser` package'):
      play.main(argv)
    return
  monkeypatch.setenv('DISPLAY', display)
  made = []
  monkeypatch.setattr(mujoco.viewer, 'launch_passive', lambda mj, md, **kw:
                      made.append(_ThreeFrames(mj, md, **kw)) or made[-1])
  stats = play.main(argv)
  assert np.isfinite(stats['mean_reward'])
  (window,) = made
  assert window.syncs == 3 and window.closed
  assert window.user_scn.ngeom == 3  # the velocity command's arrows


# ---------------------------------------------------------------------------
# the viser viewer (the fake viser of tests/test_optional_deps.py)
# ---------------------------------------------------------------------------


class _Handle:
  """Generic viser handle fake: records attribute writes, supports the
  on_click/on_update callback registration the GUI handles expose."""

  def __init__(self, kind, name, kwargs):
    self.kind = kind
    self.name = name
    self.kwargs = kwargs
    self.value = kwargs.get('initial_value')
    self.content = kwargs.get('content')
    self.visible = kwargs.get('visible', True)
    self.data = kwargs.get('data')
    self.callbacks = []

  def on_click(self, cb):
    self.callbacks.append(cb)

  def on_update(self, cb):
    self.callbacks.append(cb)


class _Registry:

  def __init__(self):
    self.handles = []

  def _add(self, kind, name, kwargs):
    h = _Handle(kind, name, kwargs)
    self.handles.append(h)
    return h


class _FakeGui(_Registry):

  def add_button(self, name, **kw):
    return self._add('button', name, kw)

  def add_slider(self, name, **kw):
    return self._add('slider', name, kw)

  def add_checkbox(self, name, **kw):
    return self._add('checkbox', name, kw)

  def add_markdown(self, content, **kw):
    return self._add('markdown', 'md', dict(kw, content=content))

  def add_uplot(self, **kw):
    return self._add('uplot', 'plot', kw)


class _FakeScene(_Registry):

  def add_mesh_simple(self, name, **kw):
    return self._add('mesh', name, kw)

  def add_icosphere(self, name, **kw):
    return self._add('icosphere', name, kw)


def _install_fake_viser(monkeypatch):
  servers = []

  class FakeViserServer:

    def __init__(self):
      self.gui = _FakeGui()
      self.scene = _FakeScene()
      self.stopped = False
      servers.append(self)

    def stop(self):
      self.stopped = True

  fake = types.ModuleType('viser')
  fake.ViserServer = FakeViserServer
  uplot = types.ModuleType('viser.uplot')

  class Series:

    def __init__(self, **kw):
      self.kw = kw

  class Scale:

    def __init__(self, **kw):
      self.kw = kw

  uplot.Series = Series
  uplot.Scale = Scale
  fake.uplot = uplot
  monkeypatch.setitem(sys.modules, 'viser', fake)
  monkeypatch.setitem(sys.modules, 'viser.uplot', uplot)
  return servers


@pytest.fixture(scope='module')
def tiny_env():
  import mjlab_torch.tasks.velocity.config.tiny  # noqa: F401 (registers)
  from mjlab_torch.tasks import registry
  env = registry.make('Mjlab-Velocity-Flat-Tiny', device='cpu',
                      **{'scene.num_envs': 2})
  env.reset(seed=0)
  env.step(torch.zeros(2, env.action_dim))
  return env


def test_viser_viewer_primary_branch(monkeypatch, tiny_env):
  """tests/test_optional_deps.py::test_viser_viewer_primary_branch on the
  port's viewer and env."""
  servers = _install_fake_viser(monkeypatch)
  from mjlab_torch.viewer.viser_viewer import ViserViewer

  viewer = ViserViewer(tiny_env, policy=lambda obs: torch.zeros(
      (tiny_env.num_envs, tiny_env.action_dim)))
  viewer.setup()
  server = servers[0]

  # one mesh handle per renderable geom, ghost layer included
  meshes = [h for h in server.scene.handles if h.kind == 'mesh']
  assert len(meshes) >= viewer.mj.ngeom  # robot + ghost
  kinds = [h.kind for h in server.gui.handles]
  assert kinds.count('checkbox') == 2 and 'slider' in kinds
  assert viewer._plots_enabled is not None

  pause_btn = next(h for h in server.gui.handles if h.kind == 'button')
  assert not viewer.paused
  pause_btn.callbacks[0](None)
  assert viewer.paused

  contact_chk = next(h for h in server.gui.handles
                     if h.kind == 'checkbox' and 'contact' in h.name)
  contact_chk.value = True
  tiny_env.last_extras = {'Episode_Reward/alive': torch.tensor(1.0),
                          'time_outs': torch.zeros(2, dtype=torch.bool)}
  viewer.sync_env_to_viewer()
  robot_meshes = [h for h in server.scene.handles
                  if h.kind == 'mesh' and h.name.startswith('/robot')]
  posed = [h for h in robot_meshes if isinstance(
      getattr(h, 'position', None), tuple)]
  assert posed and all(np.all(np.isfinite(h.position)) for h in posed)
  np.testing.assert_array_equal(
      viewer.md.qpos, tiny_env.state.data.qpos[0].numpy())
  assert 'alive' in viewer._reward_md.content
  # the velocity command's arrows were drawn through the debug layer
  arrows = [h for h in server.scene.handles if h.name.startswith('/debug')]
  assert len(arrows) >= 3

  tiny_env.last_extras = {'Episode_Reward/alive': 2.0}
  viewer.sync_env_to_viewer()
  plots = [h for h in server.gui.handles if h.kind == 'uplot']
  assert len(plots) == 1
  x, y = plots[0].data
  assert y[-1] == 2.0 and x[-1] == 0.0
  assert not plots[0].visible

  viewer._plots_enabled.value = True
  viewer._plots_enabled.callbacks[0](None)
  assert plots[0].visible

  viewer.teardown()
  assert server.stopped


def test_viser_viewer_names_the_missing_package(monkeypatch, tiny_env):
  monkeypatch.setitem(sys.modules, 'viser', None)
  from mjlab_torch.viewer.viser_viewer import ViserViewer
  from mjlab_tpu.viewer.viser_viewer import _require_viser as jreq
  with pytest.raises(ImportError) as want:
    jreq()
  with pytest.raises(ImportError) as got:
    ViserViewer(tiny_env, policy=None).setup()
  assert str(got.value) == str(want.value).replace('mjlab_tpu', 'mjlab_torch')


# ---------------------------------------------------------------------------
# the writers' add_video
# ---------------------------------------------------------------------------


class _Recorder:

  def __init__(self, name, calls):
    self._name = name
    self.calls = calls

  def __getattr__(self, attr):
    def record(*args, **kwargs):
      self.calls.append((f'{self._name}.{attr}', args, kwargs))
    return record


def test_tensorboard_add_video_matches_jax(tmp_path, monkeypatch):
  calls = {'torch': [], 'jax': []}

  def fake_writer(lib):
    class FakeSummaryWriter(_Recorder):
      def __init__(self, log_dir):
        super().__init__('sw', calls[lib])
    return FakeSummaryWriter

  import torch.utils.tensorboard as ttb
  monkeypatch.setattr(ttb, 'SummaryWriter', fake_writer('torch'))
  tbx = types.ModuleType('tensorboardX')
  tbx.SummaryWriter = fake_writer('jax')
  monkeypatch.setitem(sys.modules, 'tensorboardX', tbx)
  from mjlab_torch.rl.writers import TensorboardWriter
  from mjlab_tpu.rl.writers import TensorboardWriter as JaxTensorboardWriter
  frames = np.arange(4 * 6 * 8 * 3, dtype=np.uint8).reshape(4, 6, 8, 3)
  for cls in (TensorboardWriter, JaxTensorboardWriter):
    cls(str(tmp_path)).add_video('Video/rollout', frames, fps=10, step=3)
  (got,), (want,) = calls['torch'], calls['jax']
  assert got[0] == want[0] == 'sw.add_video'
  assert got[1][0] == want[1][0] and got[2] == want[2] == {
      'global_step': 3, 'fps': 10}
  assert got[1][1].shape == (1, 4, 3, 6, 8)
  np.testing.assert_array_equal(got[1][1], want[1][1])


def test_wandb_add_video_matches_jax(tmp_path, monkeypatch):
  calls = []

  class FakeVideo:

    def __init__(self, arr, fps=None):
      self.arr = np.asarray(arr)
      self.fps = fps

  fake = types.ModuleType('wandb')
  fake.init = lambda project=None, name=None, dir=None: _Recorder('run',
                                                                  calls)
  fake.Video = FakeVideo
  monkeypatch.setitem(sys.modules, 'wandb', fake)
  monkeypatch.setenv('WANDB_MODE', 'offline')
  from mjlab_torch.rl.writers import WandbWriter
  from mjlab_tpu.rl.writers import WandbWriter as JaxWandbWriter
  frames = np.arange(4 * 6 * 8 * 3, dtype=np.uint8).reshape(4, 6, 8, 3)
  for cls in (WandbWriter, JaxWandbWriter):
    cls(str(tmp_path), project='p').add_video('Video/rollout', frames,
                                              fps=25, step=9)
  got, want = (c[1][0]['Video/rollout'] for c in calls)
  assert calls[0][2] == calls[1][2] == {'step': 9}
  assert got.arr.shape == (4, 3, 6, 8) and got.fps == want.fps == 25
  np.testing.assert_array_equal(got.arr, want.arr)
