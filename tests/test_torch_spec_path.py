"""The port's spec path against the JAX package's.

Scenes composed from cfgs (mjlab_torch/scene/scene.py, entity/entity.py,
entity/spec_config.py, asset_zoo/spec_builder.py with the visual meshes,
terrains/importer.py, MujocoCfg.edit_spec): for every registered task the
port's compiled scene equals the JAX package's MjModel field for field;
each committed snapshot is a fresh compile, bit for bit, recording its
cfg's spec inputs, and every task takes it by digest; each spec editor
alone against its JAX counterpart; the STL reader and the mesh packs
against the JAX reader on every shipped STL; `MujocoCfg.apply` after the
compile against `edit_spec` before it; the visual meshes change no
physics; the route rule (an edited cfg composes with mujoco and raises
without it); the fixture tool against the JAX tool's fixture; and the
JAX package's round-4 blowup ring replayed on the port's G1 against its
record."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import mujoco
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
import mjlab_torch.tasks.tracking.config.tiny  # noqa: F401 (registers)
import mjlab_torch.tasks.velocity.config.tiny  # noqa: F401 (registers)
import mjlab_tpu.tasks.tracking.config.tiny  # noqa: F401 (registers)
import mjlab_tpu.tasks.velocity.config.tiny  # noqa: F401 (registers)
from mjlab_torch import asset_zoo
from mjlab_torch.asset_zoo import stl as tstl
from mjlab_torch.physics import io as tio
from mjlab_torch.scene import scene as tscene
from mjlab_torch.tasks import registry as treg
from mjlab_tpu.tasks import registry as jreg
import torch_parity  # noqa: F401 (one intra-op thread)
from chip_smoke import knees_doubled

ROOT = Path(__file__).resolve().parents[1]
RING = ROOT / 'artifacts' / 'blowups_r4' / 'blowup_ring.npz'
JAX_FIXTURE = ROOT / 'tests' / 'data' / 'blowup_ls_fixture.npz'
TASKS = tuple(sorted(treg.registered_tasks()))
G1_FLAT = 'Mjlab-Velocity-Flat-Unitree-G1'
SNAPSHOTS = {'g1_flat': asset_zoo.G1_FLAT, 'go1_flat': asset_zoo.GO1_FLAT,
             'g1_tracking': asset_zoo.G1_TRACKING,
             'tiny_flat': asset_zoo.TINY_FLAT}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _fields(m, prefix='') -> dict:
  """Every numpy array, bytes, int and float of an MjModel, with those of
  its opt, stat and vis structs."""
  out = {}
  for k in dir(m):
    if k.startswith('_'):
      continue
    try:
      v = getattr(m, k)
    except Exception:  # noqa: BLE001 (attributes that raise when read)
      continue
    if isinstance(v, (np.ndarray, bytes, int, float)):
      out[prefix + k] = v
    elif k in ('opt', 'stat', 'vis') and not prefix:
      out.update(_fields(v, f'{k}.'))
    elif prefix == 'vis.' and hasattr(v, '__dir__') and not callable(v):
      out.update(_fields(v, f'vis.{k}.'))
  return out


def assert_same_model(a, b) -> None:
  """Two MjModels equal field for field: every array (NaN-equal, of one
  dtype and shape), every name, every size and option."""
  fa, fb = _fields(a), _fields(b)
  assert sorted(fa) == sorted(fb)
  bad = []
  for k, x in fa.items():
    y = fb[k]
    if isinstance(x, np.ndarray):
      same = (x.shape == y.shape and x.dtype == y.dtype
              and np.array_equal(x, y, equal_nan=x.dtype.kind in 'fc'))
    else:
      same = x == y or (x != x and y != y)
    if not same:
      bad.append(k)
  assert not bad, bad
  assert a.names == b.names


def _no_motion(monkeypatch):
  """The tracking cfgs without their default clip: the scene does not
  depend on it, and writing it costs a G1 FK rollout in each package."""
  from mjlab_torch.tasks.tracking.config.g1 import flat_env_cfg as tf
  from mjlab_tpu.tasks.tracking.config.g1 import flat_env_cfg as jf
  monkeypatch.setattr(tf, 'default_motion_file', lambda: 'unused.npz')
  monkeypatch.setattr(jf, 'default_motion_file', lambda: 'unused.npz')


def _cfgs(task):
  tc, jc = treg.load_cfg(task), jreg.load_cfg(task)
  tc.scene.num_envs = jc.scene.num_envs = 2
  return tc, jc


_COMPILED: dict = {}


def _port_compile(scene_cfg, mujoco_cfg):
  """The port's compile of a scene with `mujoco_cfg` written into its
  spec, each distinct (scene, options) compiled once in this module."""
  key = ('port', tscene.spec_digest(tscene.spec_inputs(scene_cfg)),
         repr(mujoco_cfg))
  if key not in _COMPILED:
    _COMPILED[key] = tscene.compile_scene(scene_cfg, mujoco_cfg)
  return _COMPILED[key]


def _compiled(tc, jc):
  """(the port's compile, the JAX package's) of a task's scene, each
  distinct scene compiled once in this module."""
  key = ('jax', tscene.spec_digest(tscene.spec_inputs(tc.scene)),
         repr(tc.sim.mujoco))
  if key not in _COMPILED:
    from mjlab_tpu.scene.scene import Scene
    scene = Scene(jc.scene)
    jc.sim.mujoco.edit_spec(scene.spec)
    _COMPILED[key] = scene.compile()
  return _port_compile(tc.scene, tc.sim.mujoco), _COMPILED[key]


@functools.lru_cache(maxsize=None)
def _g1_flat_bare():
  """The G1 flat scene compiled with no MujocoCfg written into its spec."""
  return tscene.compose_spec(treg.load_cfg(G1_FLAT).scene).compile()


# ---------------------------------------------------------------------------
# scenes composed from cfgs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('task', TASKS)
def test_scene_matches_jax(task, monkeypatch):
  """The port's scene of the task, composed from its cfgs with its
  MujocoCfg written into the spec, is the JAX package's MjModel; the
  Scene of the cfg takes the committed snapshot (by digest) and builds
  the same engine Model from it as from the compile."""
  _no_motion(monkeypatch)
  tc, jc = _cfgs(task)
  port, jax_model = _compiled(tc, jc)
  assert_same_model(port, jax_model)
  scene = tscene.Scene(tc.scene, device='cpu', dtype=torch.float64)
  assert not scene.composed
  assert scene.mj_model.spec_digest == scene.digest
  scene.apply_options(tc.sim.mujoco)
  a = scene.initialize(tc.sim.nconmax)
  b = tphys.put_model(port, device='cpu', dtype=torch.float64,
                      ncon_cap=tc.sim.nconmax)
  assert a.stat == b.stat
  for f in tio.MODEL_FIELDS:
    assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize('name', sorted(SNAPSHOTS))
def test_snapshot_is_a_fresh_compile(name, monkeypatch):
  """Each committed task snapshot is the snapshot of a fresh spec-path
  compile bit for bit, and records its cfg's spec inputs and digest."""
  _no_motion(monkeypatch)
  task = SNAPSHOTS[name]
  tc, jc = _cfgs(task)
  inputs = tscene.spec_inputs(tc.scene)
  fresh = tscene.recording(tio.ModelArrays.of(_compiled(tc, jc)[0]), inputs)
  saved = asset_zoo.arrays(task)
  a, b = saved.arrays(), fresh.arrays()
  assert sorted(a) == sorted(b)
  for k in a:
    assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
  assert saved.spec_inputs == inputs
  assert saved.spec_digest == tscene.spec_digest(inputs)


def test_g1_snapshot_has_the_jax_envs_geoms():
  """The G1 snapshots hold the JAX env's 69 geoms, 35 of them visual
  meshes, with no mesh table (every mesh is visual-only)."""
  for snap in (asset_zoo.g1_flat_arrays(), asset_zoo.tracking_arrays()):
    assert snap.ngeom == 69
    assert int((snap.geom_type == int(mujoco.mjtGeom.mjGEOM_MESH)).sum()) \
        == 35
    assert snap.nmesh == 0 and 'mesh_vert' not in snap.arrays()


# ---------------------------------------------------------------------------
# the editors, one at a time
# ---------------------------------------------------------------------------


def _editor_cases(sc):
  """{case: [editors]} built from a spec_config module `sc`."""
  return {
      'actuators': [sc.ActuatorSetCfg(cfgs=(
          sc.ActuatorCfg(['shoulder'], 5.0, 10.0, 0.5, frictionloss=0.1,
                         armature=0.01),
          sc.ActuatorCfg(['.*'], 8.0, 20.0, 1.0, armature=0.002)))],
      'collision': [sc.CollisionCfg(
          geom_names_expr=['.*_collision'],
          contype={'foot0.*': 2, '.*': 1}, conaffinity={'base.*': 3},
          condim={'foot.*': 6, '.*_collision': 1},
          priority={'foot1.*': 2}, friction={'foot.*': (0.7, 0.01)},
          solref={'base.*': (0.03, 1.2)},
          solimp={'.*': (0.8, 0.9, 0.01)})],
      'sensors': [
          sc.ContactSensorCfg(name='foot_arm', geom1='foot0_collision',
                              body2='forearm', num=3,
                              data=('found', 'force', 'dist'),
                              reduce='mindist'),
          sc.ContactSensorCfg(name='base_self', subtree1='base',
                              subtree2='base', num=2, reduce='netforce'),
          sc.SensorCfg(name='gyro', sensor_type='gyro', objtype='site',
                       objname='imu'),
          sc.SensorCfg(name='arm_quat', sensor_type='framequat',
                       objtype='body', objname='forearm', reftype='body',
                       refname='base')],
      'light': [sc.LightCfg(name='key', body='base', mode='trackcom',
                            type='directional', castshadow=False,
                            pos=(0.0, 0.0, 2.0), dir=(0.0, 0.3, -1.0))],
      'camera': [sc.CameraCfg(name='cam', body='base', mode='targetbody',
                              target='forearm', fovy=60.0,
                              pos=(1.0, 0.0, 0.5),
                              quat=(0.9, 0.1, 0.0, 0.0))],
      'texture': [sc.TextureCfg(name='grid', type='2d', builtin='checker',
                                rgb1=(0.1, 0.2, 0.3), rgb2=(0.6, 0.6, 0.6),
                                width=32, height=32, mark='edge',
                                markrgb=(1.0, 1.0, 1.0))],
      'material': [
          sc.TextureCfg(name='grid', type='2d', builtin='checker',
                        rgb1=(0.1, 0.2, 0.3), rgb2=(0.6, 0.6, 0.6),
                        width=32, height=32),
          sc.MaterialCfg(name='mat', texuniform=True, texrepeat=(2.0, 2.0),
                         reflectance=0.2, texture='grid')],
  }


@pytest.mark.parametrize('case', sorted(_editor_cases(
    __import__('mjlab_torch.entity.spec_config', fromlist=['x']))))
def test_editor_matches_jax(case):
  """Each editor alone on the TinyBot's spec: the port's and the JAX
  package's compile to equal MjModels. The actuator case has two cfgs
  matching one joint (the last wins), the collision case dict fields
  whose regexes overlap (the first wins)."""
  from mjlab_torch.asset_zoo.spec_builder import build_robot_spec as tbuild
  from mjlab_torch.asset_zoo.tiny_bot import SPEC_DATA
  from mjlab_torch.entity import spec_config as tsc
  from mjlab_tpu.asset_zoo.spec_builder import build_robot_spec as jbuild
  from mjlab_tpu.entity import spec_config as jsc
  models = []
  for build, sc in ((tbuild, tsc), (jbuild, jsc)):
    spec = build(SPEC_DATA)
    for editor in _editor_cases(sc)[case]:
      editor.edit_spec(spec)
    models.append(spec.compile())
  assert_same_model(*models)
  if case == 'actuators':
    assert models[0].actuator_gainprm[:, 0].tolist() == [20.0, 20.0]
  if case == 'sensors':
    # found, force (3) and dist for 3 contacts; found for 2
    assert models[0].sensor_dim.tolist()[:2] == [3 * 5, 2]


def test_stl_reader_and_packs_match_the_jax_reader(tmp_path):
  """On every STL the JAX package ships, the port's reader returns the
  JAX reader's arrays bit for bit, and so does each robot's mesh pack;
  an ASCII STL reads alike."""
  from mjlab_tpu.asset_zoo import stl as jstl
  robots = ROOT / 'mjlab_tpu' / 'asset_zoo' / 'robots'
  count = 0
  for robot in ('unitree_g1', 'unitree_go1'):
    files = sorted((robots / robot / 'assets').iterdir())
    pack = tstl.load_pack(str(ROOT / 'mjlab_torch' / 'asset_zoo' / 'robots'
                              / robot / 'assets' / tstl.MESH_PACK))
    assert sorted(pack) == [f.name for f in files]
    for f in files:
      want = jstl.load_stl(str(f))
      for got in (tstl.load_stl(str(f)), pack[f.name]):
        for g, w in zip(got, want):
          assert g.dtype == w.dtype and np.array_equal(g, w), f.name
      count += 1
  assert count == 39
  ascii_stl = tmp_path / 'tet.stl'
  corners = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]
  faces = [(0, 2, 1), (0, 1, 3), (0, 3, 2), (1, 2, 3)]
  lines = ['solid tet']
  for f in faces:
    lines += ['facet normal 0 0 0', 'outer loop']
    lines += [f'vertex {x} {y} {z}' for x, y, z in (corners[i] for i in f)]
    lines += ['endloop', 'endfacet']
  ascii_stl.write_text('\n'.join(lines + ['endsolid tet']))
  for g, w in zip(tstl.load_stl(str(ascii_stl)),
                  jstl.load_stl(str(ascii_stl))):
    assert np.array_equal(g, w)


@pytest.mark.parametrize('options', ['defaults', 'elliptic', 'euler'])
def test_apply_after_compile_is_edit_spec_before(options):
  """`apply(compile(spec))` and `compile(edit_spec(spec))` of the G1 flat
  scene are one MjModel, for the velocity cfg's options, the elliptic cone
  and the Euler integrator."""
  tc = treg.load_cfg(G1_FLAT)
  mcfg = tc.sim.mujoco
  if options == 'elliptic':
    mcfg.cone = 'elliptic'
  elif options == 'euler':
    mcfg.integrator = 'euler'
  assert_same_model(mcfg.apply(_g1_flat_bare()),
                    _port_compile(tc.scene, mcfg))


def _lockstep_rollouts(pairs, substeps: int) -> list:
  """`substeps` physics steps of each (Model, Data) of `pairs` (two), each
  in a thread of its own, in lockstep at the two costliest stages of a
  substep on the CPU: the plain Newton solve and the plain SPD solve (the
  implicit integrator's; the Newton solve's own run inside it). The two
  threads' calls meet, and where their batched arguments have the same
  shapes they run as one call on both batches, each thread taking its
  rows back. Batching changes an env's rows in the last bits only
  (test_lockstep_rollouts_are_the_rollouts). Returns each pair's last
  Data."""
  import threading

  from mjlab_torch.ops import pd_solve
  from mjlab_torch.physics import solver
  meet = threading.Barrier(len(pairs), timeout=300)
  slots, outs = [None] * len(pairs), [None] * len(pairs)
  local = threading.local()

  def paired(fn, nb):
    """fn, whose first `nb` arguments are batched tensors, called by both
    threads at once; the rest of its arguments must be the same."""
    def call(*args):
      if getattr(local, 'inside', False):  # within the paired call
        return fn(*args)
      i = local.index
      slots[i] = args
      meet.wait()
      if i == 0:
        local.inside = True
        try:
          a, b = slots
          same = all(x.shape[1:] == y.shape[1:]
                     for x, y in zip(a[:nb], b[:nb]))
          rest = all(x is y or np.array_equal(x, y)
                     for x, y in zip(a[nb:], b[nb:]))
          if same and rest:
            n = a[0].shape[0]
            both = fn(*[torch.cat([x, y]) for x, y in zip(a[:nb], b[:nb])],
                      *a[nb:])
            cut = lambda r: ((r[:n], r[n:]) if torch.is_tensor(r)
                             else (tuple(t[:n] for t in r),
                                   tuple(t[n:] for t in r)))
            outs[:] = cut(both)
          else:
            outs[:] = [fn(*a), fn(*b)]
        finally:
          local.inside = False
      meet.wait()
      return outs[i]
    return call

  results, errors = [None] * len(pairs), []

  def roll(i):
    local.index = i
    m, d = pairs[i]
    try:
      for _ in range(substeps):
        d = tphys.step(m, d)
      results[i] = d
    except BaseException as e:  # the other thread is released below
      errors.append(e)
      meet.abort()

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(solver, 'newton_plain', paired(solver.newton_plain, 15))
    mp.setattr(pd_solve, 'solve_pd', paired(pd_solve.solve_pd, 2))
    threads = [threading.Thread(target=roll, args=(i,))
               for i in range(len(pairs))]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=600)
  assert not any(t.is_alive() for t in threads)
  if errors:
    raise errors[0]
  return results


def test_visual_meshes_change_no_physics():
  """The G1 flat scene with its visual meshes and without them
  (`get_spec(visuals=False)`) steps 100 substeps alike in float64: qpos
  and qvel ≤ 1e-12 apart. The two rollouts run in lockstep, their solves
  in one batch (`_lockstep_rollouts`)."""
  from mjlab_torch.asset_zoo.unitree_g1 import get_spec
  from torch_parity import g1_states
  tc = treg.load_cfg(G1_FLAT)
  with_vis = _port_compile(tc.scene, tc.sim.mujoco)
  robot = tc.scene.entities['robot']
  robot.spec_fn = functools.partial(get_spec, visuals=False)
  without = tscene.compile_scene(tc.scene, tc.sim.mujoco)
  assert (with_vis.ngeom, without.ngeom) == (69, 34)
  qpos, qvel, ctrl = g1_states(with_vis, 1, seed=5, drop=0.02)
  pairs = []
  for mj in (with_vis, without):
    m = tphys.put_model(mj, device='cpu', dtype=torch.float64)
    pairs.append((m, tphys.make_batched_data(m, 1, device='cpu').replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
        ctrl=torch.as_tensor(ctrl))))
  out = _lockstep_rollouts(pairs, 100)
  assert bool((out[0].contact.dist < 0).any())  # feet on the floor
  for f in ('qpos', 'qvel'):
    diff = (getattr(out[0], f) - getattr(out[1], f)).abs().max()
    assert float(diff) <= 1e-12, (f, float(diff))


def test_lockstep_rollouts_are_the_rollouts():
  """_lockstep_rollouts steps each model as tphys.step does alone: the G1
  flat snapshot from two states over 3 substeps, within 1e-12 of
  (1 + max |alone|) (the batched solves round otherwise in the last
  bits)."""
  from torch_parity import g1_states
  arrays = asset_zoo.g1_flat_arrays()
  m = tphys.put_model(arrays, device='cpu', dtype=torch.float64)
  pairs, alone = [], []
  for seed in (1, 2):
    qpos, qvel, ctrl = g1_states(arrays, 1, seed=seed, drop=0.02)
    d = tphys.make_batched_data(m, 1, device='cpu').replace(
        qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
        ctrl=torch.as_tensor(ctrl))
    pairs.append((m, d))
    for _ in range(3):
      d = tphys.step(m, d)
    alone.append(d)
  for got, want in zip(_lockstep_rollouts(pairs, 3), alone):
    for f in ('qpos', 'qvel', 'qacc', 'efc_force'):
      g, w = getattr(got, f), getattr(want, f)
      err = float((g - w).abs().max() / (1 + w.abs().max()))
      assert err <= 1e-12, (f, err)


# ---------------------------------------------------------------------------
# the route rule
# ---------------------------------------------------------------------------


def test_edited_cfg_composes_its_own_scene():
  """A G1 flat cfg with the knee stiffness doubled does not take the
  registered snapshot: on a host with mujoco its scene is composed from
  the cfgs, and the servos of that ActuatorCfg's joints (the knees and the
  hip roll joints) have the doubled gain, the others the snapshot's."""
  cfg = knees_doubled(treg.load_cfg(G1_FLAT))
  scene = tscene.Scene(cfg.scene, device='cpu')
  assert scene.composed
  assert scene.digest != asset_zoo.g1_flat_arrays().spec_digest
  scene.apply_options(cfg.sim.mujoco)
  mj = scene.mj_model
  snap = asset_zoo.g1_flat_arrays()
  knees = [i for i in range(mj.nu) if mujoco.mj_id2name(
      mj, mujoco.mjtObj.mjOBJ_ACTUATOR, i).endswith(
          ('_knee_joint', '_hip_roll_joint'))]
  assert len(knees) == 4
  np.testing.assert_array_equal(mj.actuator_gainprm[knees, 0],
                                2 * snap.actuator_gainprm[knees, 0])
  others = [i for i in range(mj.nu) if i not in knees]
  np.testing.assert_array_equal(mj.actuator_gainprm[others],
                                snap.actuator_gainprm[others])


def test_edited_cfg_raises_without_mujoco():
  """With mujoco unimportable, the edited cfg's env is refused before it
  steps: the error names both digests and the first differing input."""
  code = f"""
import sys; sys.modules['mujoco'] = None
from chip_smoke import knees_doubled
from mjlab_torch.asset_zoo import g1_flat_arrays
from mjlab_torch.scene.scene import spec_digest, spec_inputs
from mjlab_torch.tasks import registry
cfg = knees_doubled(registry.load_cfg({G1_FLAT!r}))
try:
  registry.make({G1_FLAT!r}, cfg=cfg, device='cpu', **{{'scene.num_envs': 2}})
except RuntimeError as e:
  msg = str(e)
  assert spec_digest(spec_inputs(cfg.scene)) in msg, msg
  assert g1_flat_arrays().spec_digest in msg, msg
  assert 'actuator' in msg and 'mujoco' in msg, msg
  print('refused')
"""
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, 'OMP_NUM_THREADS': '1'})
  assert out.returncode == 0, out.stderr
  assert out.stdout.strip() == 'refused'


# ---------------------------------------------------------------------------
# the round-4 blowup ring on the port
# ---------------------------------------------------------------------------


def _tool(name):
  spec = importlib.util.spec_from_file_location(name, ROOT / 'tools'
                                                / f'{name}.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def test_fixture_tool_matches_the_jax_tools_fixture():
  """tools/make_torch_blowup_fixture.py, on the port alone, freezes the
  Newton inputs of the biting substep that the JAX package's tool froze
  (tests/data/blowup_ls_fixture.npz), float32 on both sides: every key,
  shape and dtype; the parameters and masks equal; the benign ring row
  within 1e-5 of (1 + max |ref|) (measured 8.95e-6). The biting row's
  four substeps under the unguarded polish amplify float32 rounding: its
  arrays are within 1e-4 (measured 6.5e-5; a float64 replay puts each
  package's float32 fixture up to 1.6e-4 from it). Its unguarded polish
  still bites and the guarded one holds it. Unless asked for the CPU,
  the tool wants the GPU."""
  tool = _tool('make_torch_blowup_fixture')
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      tool.fixture(str(RING))
  out = tool.fixture(str(RING), device='cpu')
  with np.load(JAX_FIXTURE) as z:
    ref = {k: z[k] for k in z.files}
  assert sorted(out) == sorted(ref)
  for k, want in ref.items():
    got = out[k]
    assert got.shape == want.shape and got.dtype == want.dtype, k
    if want.dtype.kind in 'biu' or want.ndim == 0:
      np.testing.assert_array_equal(got, want, err_msg=k)
      continue
    for row, tol in ((1, 1e-5), (0, 1e-4)):  # ring rows 0 and 38
      w = want[row].astype(np.float64)
      err = np.abs(got[row] - w).max() / (1.0 + np.abs(w).max())
      assert err <= tol, (k, row, err)
  from test_torch_solver import _post_substep_qvel
  limit = float(out['qvel_limit'])
  safe = _post_substep_qvel(out, unsafe=False)
  bite = _post_substep_qvel(out, unsafe=True)
  assert safe.max() < 0.2 * limit and bite[0] > limit > 5 * bite[1]


def _recorded_replay():
  """replay_fixed.txt's env-f32 rows: {substep: (p50, max)}."""
  text = (ROOT / 'artifacts' / 'blowups_r4' / 'replay_fixed.txt').read_text()
  for line in text.splitlines():
    if line.startswith('{') and '"env-f32"' in line:
      rows = json.loads(line)['substeps']
      return {r['substep']: (r['qvel_max_p50'], r['qvel_max_max'])
              for r in rows}
  raise AssertionError('no env-f32 row in replay_fixed.txt')


def test_round4_ring_replays_as_recorded():
  """The JAX package's round-4 ring (40 envs, model_geom_friction of 69
  geoms) replays through the port's G1 flat env path on the CPU in
  float32 for 8 substeps: not reproduced, and each substep's max |qvel|
  within 1e-3 relative of replay_fixed.txt's."""
  from mjlab_torch.scripts import blowup_replay
  _, (r,) = blowup_replay.replay(str(RING), substeps=8,
                                 variants=('env-f32',), device='cpu')
  assert r['envs'] == 40 and not r['reproduced']
  want = _recorded_replay()
  assert sorted(want) == [row['substep'] for row in r['substeps']]
  for row in r['substeps']:
    w = want[row['substep']][1]
    assert abs(row['qvel_max_max'] - w) <= 1e-3 * w, (row, w)


def test_ring_keys_are_checked_and_copies_tiled():
  """blowup_replay refuses a ring whose model field or state does not fit
  the env (the port's ring from before its scenes carried the visual
  meshes: 34 geoms), tiles a ring's rows over a batch (row e holds row
  e mod n) and measures how far a copy strays from its row's first copy,
  a NaN counting as infinitely far."""
  from types import SimpleNamespace

  from mjlab_torch.scripts import blowup_replay as br
  with np.load(RING) as z:
    ring = {k: z[k] for k in z.files}
  data = SimpleNamespace(**{k: torch.zeros((2,) + ring[k].shape[1:])
                            for k in br.STATE_KEYS})
  model = SimpleNamespace(geom_friction=torch.zeros(2, 69, 3))
  br.check_ring(ring, data, model)  # the JAX package's ring fits
  for bad in ({'model_geom_friction': ring['model_geom_friction'][:, :34]},
              {'qvel': ring['qvel'][:, :30]}, {'mocap_pos': ring['qpos']}):
    with pytest.raises(SystemExit, match=next(iter(bad))):
      br.check_ring({**ring, **bad}, data, model)
  place = br._placement(ring, 100, tile=True)
  full = br._padded(ring, place, {'qpos': np.zeros((100, 36))}, tile=True)
  assert place.tolist() == list(range(40))
  np.testing.assert_array_equal(full['qpos'], ring['qpos'][np.arange(100)
                                                          % 40])
  traj = [SimpleNamespace(qpos=torch.as_tensor(full['qpos']),
                          qvel=torch.zeros(100, 35))]
  assert br.copies_error(traj, 40) == 0.0
  traj[0].qvel[77, 3] = 0.5
  assert br.copies_error(traj, 40) == 0.5
  traj[0].qvel[77, 3] = float('nan')
  assert br.copies_error(traj, 40) == float('inf')
