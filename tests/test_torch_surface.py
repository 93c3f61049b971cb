"""The public functions, constants and import paths that the port took on
to match the JAX package's public surface, each against its JAX
counterpart (float64, seeded with numpy): the quaternion and spatial
helpers of utils/math.py and physics/math.py, `cho_solve`, `solve_m`,
`densify_efc` on a state with equality, joint-limit and contact rows,
`nefc_max`, the enums, `rpm_to_rad`, `print_cfg`, the terrains package's
re-exports, the robots' data tables and motor constants, the build-time
entity's finders, and `SIM_CFG`, of which every env cfg holds its own
copy."""

import contextlib
import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import linalg as jlinalg
from mjlab_tpu.physics import math as jpm
from mjlab_tpu.physics import smooth as jsmooth
from mjlab_tpu.utils import math as jum
import mjlab_torch.physics as tphys
from mjlab_torch.physics import constraint as tcon
from mjlab_torch.physics import linalg as tlinalg
from mjlab_torch.physics import math as tpm
from mjlab_torch.physics import smooth as tsmooth
from mjlab_torch.utils import math as tum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12


def _close(got, want, what='', tol=TOL):
  got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _quats(rng, n):
  q = rng.normal(size=(n, 4))
  return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotations(rng, n):
  """Rotation matrices: random ones, the identity, and half turns about
  each axis (the four branches of mat_to_quat)."""
  q = _quats(rng, n)
  extra = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
                    [0.01, 0.99995, 0, 0]], float)
  extra /= np.linalg.norm(extra, axis=-1, keepdims=True)
  return np.array(jpm.quat_to_mat(jnp.asarray(np.concatenate([q, extra]))))


def _math_cases():
  rng = np.random.default_rng(0)
  n = 64
  q1, q2 = _quats(rng, n), _quats(rng, n)
  near = q1 + 1e-9 * rng.normal(size=q1.shape)  # tiny differences
  near /= np.linalg.norm(near, axis=-1, keepdims=True)
  v = rng.normal(size=(n, 3))
  axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
  angle = rng.uniform(-4, 4, n)
  t = rng.uniform(0, 1, n)
  f6, m6 = rng.normal(size=(n, 6)), rng.normal(size=(n, 6))
  a = rng.normal(size=(n, 6, 6))
  return {
      'utils.axis_angle_to_quat': ('axis_angle_to_quat', (axis, angle)),
      'utils.euler_xyz_from_quat': ('euler_xyz_from_quat', (q1,)),
      'utils.mat_to_quat': ('mat_to_quat', (_rotations(rng, n),)),
      'utils.quat_slerp': ('quat_slerp', (q1, q2, t)),
      'utils.quat_slerp/scalar': ('quat_slerp', (q1, q2, 0.3)),
      'utils.quat_slerp/near': ('quat_slerp', (q1, near, t)),
      'utils.quat_slerp/opposite': ('quat_slerp', (q1, -near, t)),
      'utils.quat_box_minus': ('quat_box_minus', (q1, q2)),
      'utils.quat_box_minus/near': ('quat_box_minus', (q1, near)),
      'utils.quat_rotate': ('quat_rotate', (q1, v)),
      'utils.quat_rotate_inverse': ('quat_rotate_inverse', (q1, v)),
      'utils.rot_vec_quat_inv': ('rot_vec_quat_inv', (v, q1)),
      'physics.rot_vec_quat_inv': ('rot_vec_quat_inv', (v, q1)),
      'physics.quat_sub': ('quat_sub', (q1, q2)),
      'physics.quat_sub/near': ('quat_sub', (q1, near)),
      'physics.transform_force': ('transform_force', (f6, v)),
      'physics.inert_mul': ('inert_mul', (a, m6)),
  }


MATH = _math_cases()


@pytest.mark.parametrize('case', list(MATH))
def test_math_matches_jax(case):
  name, args = MATH[case]
  jmod, tmod = (jum, tum) if case.startswith('utils') else (jpm, tpm)
  jargs = [jnp.asarray(a) for a in args]
  targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a
           for a in args]
  want = getattr(jmod, name)(*jargs)
  got = getattr(tmod, name)(*targs)
  if isinstance(want, tuple):
    assert len(got) == len(want)
    for g, w in zip(got, want):
      _close(g, w, case)
  else:
    _close(got, want, case)


def test_one_rot_vec_quat_inv():
  """utils/math re-exports physics/math's rot_vec_quat_inv, the one
  implementation, and the inverse rotations go through it."""
  assert tum.rot_vec_quat_inv is tpm.rot_vec_quat_inv
  assert tum.quat_rotate is tum.quat_apply
  assert tum.quat_rotate_inverse is tum.quat_apply_inverse
  rng = np.random.default_rng(1)
  q, v = torch.as_tensor(_quats(rng, 8)), torch.as_tensor(
      rng.normal(size=(8, 3)))
  _close(tum.quat_apply_inverse(q, tum.quat_apply(q, v)), v.numpy(), '', 1e-14)


def _spd(rng, b, n):
  a = rng.normal(size=(b, n, n))
  return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def test_cho_solve_matches_jax():
  rng = np.random.default_rng(2)
  a, rhs = _spd(rng, 5, 35), rng.normal(size=(5, 35))
  L = np.linalg.cholesky(a)
  want = jax.vmap(jlinalg.cho_solve)(jnp.asarray(L), jnp.asarray(rhs))
  got = tlinalg.cho_solve(torch.as_tensor(L), torch.as_tensor(rhs))
  _close(got, want, 'cho_solve', 1e-12)
  _close(tlinalg.solve_pd(torch.as_tensor(a), torch.as_tensor(rhs)),
         want, 'solve_pd', 1e-12)


def test_solve_m_matches_jax():
  """solve_m reads the Data's qM; on the CPU the port's runs K1's plain
  version, the JAX one its own solve (vmapped over the envs)."""
  rng = np.random.default_rng(3)
  qm, rhs = _spd(rng, 4, 35), rng.normal(size=(4, 35))

  class D:  # a Data as solve_m reads it
    def __init__(self, qM):
      self.qM = qM

  want = jax.vmap(lambda m, r: jsmooth.solve_m(D(m), r))(
      jnp.asarray(qm), jnp.asarray(rhs))
  got = tsmooth.solve_m(D(torch.as_tensor(qm)), torch.as_tensor(rhs))
  _close(got, want, 'solve_m', 1e-12)
  _close(torch.einsum('bij,bj->bi', torch.as_tensor(qm), got), rhs,
         'M x = rhs', 1e-10)


EFC_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 0.1"/>
    <body name="A" pos="0 0 0.04">
      <freejoint/>
      <geom type="box" size=".1 .05 .05" mass="1"/>
      <body name="arm" pos="0.1 0 0">
        <joint name="hinge" type="hinge" axis="0 1 0" range="-0.3 0.3"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size=".02" mass=".2"/>
      </body>
    </body>
    <body name="B" pos="0.3 0.1 0.3">
      <freejoint/>
      <geom type="box" size=".08 .04 .04" mass="0.5"/>
    </body>
  </worldbody>
  <equality>
    <connect body1="A" body2="B" anchor="0.1 0.02 0.03"/>
  </equality>
</mujoco>"""


def test_densify_efc_with_equality_limit_and_contact_rows():
  """A box on the floor with a hinged arm past its limit, connected to a
  second body: the port's dense views of its blocks against the JAX
  densify_efc of the same blocks, env by env; the equality and limit rows
  also against MuJoCo's efc_J (no row of dof friction comes before them)."""
  mj = mujoco.MjModel.from_xml_string(EFC_XML)
  qpos = np.tile(mj.qpos0, (2, 1))
  qpos[0, 7], qpos[1, 7] = 0.4, -0.35  # the hinge past +-0.3
  qpos[1, 2] -= 0.01  # the box deeper into the floor
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  td = tphys.make_batched_data(tm, 2, device='cpu').replace(
      qpos=torch.as_tensor(qpos))
  td = tphys.pipeline.fwd_velocity(tm, tphys.pipeline.fwd_position(tm, td))
  efc = tcon.make_efc(tm, td)
  got = tcon.densify_efc(tm.stat, efc)
  lay = tcon.efc_layout(tm.stat)
  assert (lay.ne, lay.nl, lay.nlt) == (3, 1, 0) and lay.ncr > 0
  jm = jio.put_model(mj, dtype=jnp.float64)
  for b in range(2):
    want = jcon.densify_efc(jm.stat, {k: jnp.asarray(v[b].numpy())
                                      for k, v in efc.items()})
    assert set(got) == set(want)
    for k in got:
      _close(got[k][b], want[k], f'env {b} dense {k}')
  ne, nv = lay.ne, lay.nf
  lim = ne + nv
  assert got['active'][:, :ne].all() and got['active'][:, lim].all()
  assert not got['oneside'][:, :ne].any() and got['oneside'][:, lim:].all()
  assert got['active'][:, lim + 1:].any(-1).all()  # contacts in both envs
  for b in range(2):
    md = mujoco.MjData(mj)
    md.qpos[:] = qpos[b]
    mujoco.mj_forward(mj, md)
    efc_j = np.asarray(md.efc_J).reshape(md.nefc, mj.nv)
    assert list(md.efc_type[:ne + 1]) == [0] * ne + [3]  # mjCNSTR_LIMIT_JOINT
    _close(got['J'][b, :ne], efc_j[:ne], f'env {b} equality J', 1e-9)
    _close(got['J'][b, lim], efc_j[ne], f'env {b} limit J', 1e-12)


def test_nefc_max_matches_jax():
  from mjlab_torch.asset_zoo import g1_flat_arrays
  from mjlab_torch.asset_zoo.oracle_models import NAMES, oracle_model
  from torch_parity import g1_flat_mjmodel
  models = {n: oracle_model(n) for n in NAMES}
  models['g1_flat'] = g1_flat_mjmodel()
  for name, mj in models.items():
    want = jio.nefc_max(jio.put_model(mj).stat)
    got = tphys.io.nefc_max(tphys.put_model(mj, device='cpu').stat)
    assert got == want, name
  stat = tphys.put_model(g1_flat_arrays(), device='cpu').stat
  assert tphys.io.nefc_max(stat) == tcon.efc_layout(stat).nefc


def test_enums_and_constants_match_jax():
  from mjlab_tpu import physics as jphys
  from mjlab_tpu.physics import pipeline as jpipe
  from mjlab_tpu.physics import sensor as jsen
  from mjlab_tpu.physics import types as jtypes
  from mjlab_tpu.utils import actuator as jact
  from mjlab_torch.physics import pipeline as tpipe
  from mjlab_torch.physics import sensor as tsen
  from mjlab_torch.physics import types as ttypes
  from mjlab_torch.utils import actuator as tact
  for name in ('ConeType', 'DisableBit', 'GeomType', 'IntegratorType',
               'JointType'):
    jenum, tenum = getattr(jphys, name), getattr(tphys, name)
    assert {m.name: int(m) for m in jenum} == {m.name: int(m)
                                               for m in tenum}, name
  assert tphys.Option is ttypes.Option
  assert {m.name: int(m) for m in tpipe.GainType} == {
      m.name: int(m) for m in jpipe.GainType}
  # mjtTrn: the JAX enum's SITE = 3 is mujoco's TENDON
  assert int(ttypes.TrnType.JOINT) == int(jtypes.TrnType.JOINT) == int(
      mujoco.mjtTrn.mjTRN_JOINT)
  assert int(ttypes.TrnType.TENDON) == int(mujoco.mjtTrn.mjTRN_TENDON)
  assert int(ttypes.TrnType.SITE) == int(mujoco.mjtTrn.mjTRN_SITE)
  assert tsen.SUPPORTED == jsen.SUPPORTED
  for k in ('OBJ_BODY', 'OBJ_XBODY', 'OBJ_JOINT', 'OBJ_GEOM', 'OBJ_SITE'):
    assert getattr(tsen, k) == getattr(jsen, k) == int(
        getattr(mujoco.mjtObj, 'mj' + k))
  for rpm in (0.0, 60.0, 1234.5):
    assert tact.rpm_to_rad(rpm) == jact.rpm_to_rad(rpm)


def test_print_cfg_matches_jax():
  import dataclasses

  from mjlab_tpu.utils.cli import print_cfg as jprint
  from mjlab_torch.utils.cli import print_cfg as tprint

  @dataclasses.dataclass
  class Inner:
    a: float = 0.5
    b: tuple = (1, 2)

  @dataclasses.dataclass
  class Outer:
    name: str = 'x'
    inner: Inner = dataclasses.field(default_factory=Inner)
    d: dict = dataclasses.field(default_factory=lambda: {'k': 1})

  outs = []
  for fn in (jprint, tprint):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
      fn(Outer())
    outs.append(buf.getvalue())
  assert outs[0] == outs[1]
  assert '  inner.a = 0.5\n' in outs[1]


def test_terrains_package_reexports_without_mujoco_or_jax():
  """`mjlab_torch.terrains` re-exports the JAX package's 16 names; it, the
  physics package and the robots' modules import in a fresh interpreter
  that has neither jax nor mujoco."""
  import mjlab_torch.terrains as tter
  import mjlab_tpu.terrains as jter
  assert list(tter.__all__) == list(jter.__all__)
  for name in jter.__all__:
    assert getattr(tter, name) is not None, name
  code = (
      'import sys\n'
      'sys.modules["mujoco"] = None\n'
      'for m in ("jax", "jaxlib", "flax", "mjlab_tpu"):\n'
      '  sys.modules[m] = None\n'
      'import mjlab_torch.terrains, mjlab_torch.physics\n'
      'import mjlab_torch.asset_zoo.unitree_g1 as g1\n'
      'import mjlab_torch.asset_zoo.unitree_go1, '
      'mjlab_torch.asset_zoo.tiny_bot\n'
      'from mjlab_torch.terrains import ROUGH_TERRAINS_CFG, TerrainGenerator\n'
      'assert g1.SPEC_DATA["modelname"] == "g1"\n'
      'print("ok")\n')
  out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, 'PYTHONPATH': ROOT,
                            'OMP_NUM_THREADS': '1'})
  assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


@pytest.mark.parametrize('robot', ['unitree_g1', 'unitree_go1', 'tiny_bot'])
def test_robot_tables_and_specs_match_jax(robot):
  """SPEC_DATA and build_robot_spec of each robot module: the same tables,
  and the same compiled model (without the visual meshes)."""
  import importlib
  jmod = importlib.import_module(f'mjlab_tpu.asset_zoo.{robot}')
  tmod = importlib.import_module(f'mjlab_torch.asset_zoo.{robot}')
  assert tmod.SPEC_DATA == jmod.SPEC_DATA
  kw = {} if robot == 'tiny_bot' else {'visuals': False}
  jm = jmod.build_robot_spec(jmod.SPEC_DATA, **kw).compile()
  tm = tmod.build_robot_spec(tmod.SPEC_DATA, **kw).compile()
  for f in ('body_mass', 'body_pos', 'body_quat', 'body_inertia', 'jnt_type',
            'jnt_range', 'jnt_axis', 'geom_type', 'geom_size', 'geom_pos',
            'geom_friction', 'site_pos', 'cam_pos'):
    np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f), f)
  assert (tm.nbody, tm.ngeom, tm.njnt, tm.nexclude) == (
      jm.nbody, jm.ngeom, jm.njnt, jm.nexclude)


def test_g1_motor_constants_match_jax():
  from mjlab_tpu.asset_zoo import unitree_g1 as jg1
  from mjlab_torch.asset_zoo import unitree_g1 as tg1
  for cls in ('5020', '7520_14', '7520_22', '4010'):
    assert getattr(tg1, f'ARMATURE_{cls}') == getattr(jg1, f'ARMATURE_{cls}')
    ta, ja = getattr(tg1, f'ACTUATOR_{cls}'), getattr(jg1, f'ACTUATOR_{cls}')
    assert (ta.reflected_inertia, ta.velocity_limit, ta.effort_limit) == (
        ja.reflected_inertia, ja.velocity_limit, ja.effort_limit)
    assert ta.pd_gains() == ja.pd_gains()
  # the actuator cfgs are built from the public constants
  kp, _ = tg1.ACTUATOR_5020.pd_gains()
  assert tg1.G1_ACTUATOR_5020.stiffness == kp
  assert tg1.G1_ACTUATOR_ANKLE.stiffness == 2 * kp


def test_entity_finders_match_jax():
  from mjlab_tpu.asset_zoo.unitree_g1 import G1_ROBOT_CFG as jcfg
  from mjlab_tpu.entity.entity import Entity as JEntity
  from mjlab_torch.asset_zoo.unitree_g1 import G1_ROBOT_CFG as tcfg
  from mjlab_torch.entity.entity import Entity as TEntity
  je, te = JEntity(jcfg), TEntity(tcfg)
  for attr in ('body_names', 'joint_names', 'geom_names', 'site_names',
               'actuator_names', 'sensor_names', 'is_fixed_base',
               'is_articulated', 'is_actuated'):
    assert getattr(te, attr) == getattr(je, attr), attr
  for fn, expr in (('find_bodies', '.*_ankle_roll_link'),
                   ('find_joints', ['.*_knee_joint', 'waist.*']),
                   ('find_geoms', r'^(left|right)_foot[1-7]_collision$'),
                   ('find_sites', '.*'), ('find_actuators', '.*_hip_.*')):
    assert getattr(te, fn)(expr) == getattr(je, fn)(expr), fn
    assert getattr(te, fn)(expr)[0], fn


@pytest.mark.parametrize('family', ['velocity', 'tracking'])
def test_sim_cfg_is_not_shared(family):
  """Every env cfg holds its own copy of SIM_CFG: an override of one env's
  `sim.*` (as `--env.sim.*` writes it) reaches neither SIM_CFG nor another
  env's cfg. The values are the JAX package's SIM_CFG's."""
  import importlib

  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.cli import apply_overrides
  mod = importlib.import_module(
      f'mjlab_torch.tasks.{family}.{family}_env_cfg')
  jmod = importlib.import_module(
      f'mjlab_tpu.tasks.{family}.{family}_env_cfg')
  base = mod.SIM_CFG.mujoco
  assert (base.timestep, base.iterations, base.ls_iterations) == (
      jmod.SIM_CFG.mujoco.timestep, jmod.SIM_CFG.mujoco.iterations,
      jmod.SIM_CFG.mujoco.ls_iterations) == (0.005, 10, 20)
  cls = {'velocity': 'LocomotionVelocityEnvCfg',
         'tracking': 'TrackingEnvCfg'}[family]
  a, b = getattr(mod, cls)(), getattr(mod, cls)()
  assert a.sim is not b.sim and a.sim is not mod.SIM_CFG
  apply_overrides(a, ['--sim.mujoco.iterations', '3',
                      '--sim.mujoco.cone', 'elliptic'])
  assert (a.sim.mujoco.iterations, a.sim.mujoco.cone) == (3, 'elliptic')
  assert (b.sim.mujoco.iterations, b.sim.mujoco.cone) == (10, 'pyramidal')
  assert (mod.SIM_CFG.mujoco.iterations,
          mod.SIM_CFG.mujoco.cone) == (10, 'pyramidal')
  task = {'velocity': 'Mjlab-Velocity-Flat-Unitree-G1',
          'tracking': 'Mjlab-Tracking-Flat-Unitree-G1'}[family]
  c1, c2 = registry.load_cfg(task), registry.load_cfg(task)
  c1.sim.mujoco.timestep = 0.002
  assert c2.sim.mujoco.timestep == 0.005
  assert registry.load_cfg(task).sim.mujoco.timestep == 0.005
