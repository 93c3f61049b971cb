"""Parity of the port's model conversion and data allocation with the JAX
package (mjlab_torch/physics/io.py vs mjlab_tpu/physics/io.py) on the G1
flat model and TinyBot, and of the port's G1 flat scene (composed from the
task's cfgs, mjlab_torch/scene/snapshot.py) with the model the
JAX velocity env compiles."""

import dataclasses

import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import io as jio
import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import G1_FLAT, g1_flat_arrays
from mjlab_torch.physics import io as tio
from mjlab_torch.physics import mesh as tmesh
from mjlab_torch.scene import snapshot as tsnap
from torch_parity import g1_flat_mjmodel, model_leaves, tiny_bot_mjmodel

MODELS = {'g1_flat': g1_flat_mjmodel, 'tiny_bot': tiny_bot_mjmodel}


def _same(a, b, path=''):
  """Exact equality of static tables (ints, arrays, nested containers)."""
  if isinstance(a, dict):
    assert sorted(a) == sorted(b), path
    for k in a:
      _same(a[k], b[k], f'{path}[{k}]')
  elif isinstance(a, (tuple, list)):
    assert len(a) == len(b), path
    for i, (x, y) in enumerate(zip(a, b)):
      _same(x, y, f'{path}[{i}]')
  elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
  else:
    assert a == b, (path, a, b)


@pytest.mark.parametrize('name', sorted(MODELS))
def test_put_model_matches_jax(name):
  mj = MODELS[name]()
  jm = jio.put_model(mj, dtype=jnp.float64)
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  leaves = model_leaves(jm)
  for f in tio.MODEL_FIELDS:
    np.testing.assert_allclose(getattr(tm, f).numpy(), leaves[f], rtol=0,
                               atol=1e-12, err_msg=f)
  for f, v in leaves['opt'].items():
    np.testing.assert_allclose(getattr(tm.opt, f).numpy(), v, rtol=0,
                               atol=1e-12, err_msg=f'opt.{f}')
  mesh = ('geom_dataid', 'mesh_hulls')
  shared = [f.name for f in dataclasses.fields(tm.stat)
            if hasattr(jm.stat, f.name) and f.name not in ('pairs',) + mesh]
  for f in shared:
    _same(getattr(tm.stat, f), getattr(jm.stat, f), f)
  _same(tm.stat.pairs.groups, jm.stat.pairs.groups, 'pairs')
  assert tm.stat.pairs.ncon_max == jm.stat.pairs.ncon_max
  # the mesh tables: the JAX engine's where a collidable geom carries a
  # mesh, else none at all (physics/io.py _mesh_tables)
  if tmesh.collidable_meshes(mj):
    _same(tm.stat.mesh_hulls, jm.stat.mesh_hulls, 'mesh_hulls')
  else:
    assert tm.stat.mesh_hulls is None and (tm.stat.geom_dataid == -1).all()


@pytest.mark.parametrize('name', sorted(MODELS))
def test_make_data_matches_jax(name):
  mj = MODELS[name]()
  jd = jio.make_data(jio.put_model(mj, dtype=jnp.float64),
                     dtype=jnp.float64)
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  td = tphys.make_batched_data(tm, 2, device='cpu')
  assert td.batch_size == 2
  for f in tio.DATA_FIELDS:
    got = getattr(td, f).numpy()
    want = np.asarray(getattr(jd, f))
    for i in range(2):
      np.testing.assert_array_equal(got[i], want, err_msg=f)
  for f in tio.CONTACT_FIELDS:
    got = getattr(td.contact, f).numpy()
    for i in range(2):
      np.testing.assert_array_equal(got[i], np.asarray(getattr(jd.contact,
                                                               f)),
                                    err_msg=f'contact.{f}')


def test_snapshot_matches_fresh_compile():
  """The committed G1 flat snapshot is the scene builder's output, the
  spec inputs it records included."""
  fresh = tsnap.snapshot(G1_FLAT).arrays()
  saved = g1_flat_arrays().arrays()
  assert sorted(fresh) == sorted(saved)
  for k in fresh:
    np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)
  a = tphys.put_model(g1_flat_arrays(), device='cpu')
  b = tphys.put_model(tsnap.model(G1_FLAT), device='cpu')
  assert a.stat == b.stat
  for f in tio.MODEL_FIELDS:
    assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_g1_flat_scene_matches_jax_env():
  """Every physics field of the port's scene equals the velocity env's,
  all 69 geoms (the 35 visual mesh geoms among them) compared by id."""
  port, env = tsnap.model(G1_FLAT), g1_flat_mjmodel()
  for f in ('nq', 'nv', 'nu', 'nbody', 'njnt', 'nsensor', 'nsensordata',
            'nkey'):
    assert getattr(port, f) == getattr(env, f), f
  prefixes = ('body_', 'jnt_', 'dof_', 'actuator_', 'sensor_')
  for f in tio.SNAPSHOT_ARRAYS:  # the fields the engine reads
    if f.startswith(prefixes):
      np.testing.assert_allclose(getattr(port, f), getattr(env, f),
                                 rtol=1e-12, atol=1e-12, err_msg=f)
  assert port.ngeom == env.ngeom == 69
  assert (port.geom_group == 2).sum() == 35
  geom_fields = ('geom_type', 'geom_bodyid', 'geom_size', 'geom_pos',
                 'geom_quat', 'geom_friction', 'geom_condim',
                 'geom_priority', 'geom_contype', 'geom_conaffinity',
                 'geom_solref', 'geom_solimp', 'geom_solmix', 'geom_margin',
                 'geom_gap', 'geom_group', 'geom_dataid', 'geom_rgba')
  for f in geom_fields:
    np.testing.assert_array_equal(getattr(port, f), getattr(env, f),
                                  err_msg=f)
  names = lambda m, ids: [mujoco.mj_id2name(m, mujoco.mjtObj.mjOBJ_GEOM, i)
                          for i in ids]
  assert names(port, range(port.ngeom)) == names(env, range(env.ngeom))
  for f in ('timestep', 'integrator', 'cone', 'iterations', 'ls_iterations',
            'tolerance', 'ls_tolerance', 'impratio', 'gravity'):
    np.testing.assert_array_equal(getattr(port.opt, f), getattr(env.opt, f),
                                  err_msg=f'opt.{f}')
  np.testing.assert_array_equal(port.key_qpos, env.key_qpos)
  np.testing.assert_array_equal(port.key_ctrl, env.key_ctrl)
  np.testing.assert_allclose(port.stat.meaninertia, env.stat.meaninertia,
                             rtol=1e-12)
  # the same static pair table, geom for geom
  tp = tphys.put_model(port, device='cpu').stat
  te = tphys.put_model(env, device='cpu').stat
  assert (tp.pairs.ncon_max, tp.ncon_cap, tp.ncon_cap1) == (
      te.pairs.ncon_max, te.ncon_cap, te.ncon_cap1) == (533, 32, 16)
  for key, (g1, g2, pid, base, npts) in te.pairs.groups.items():
    p1, p2, ppid, pbase, pnpts = tp.pairs.groups[key]
    assert (base, npts) == (pbase, pnpts)
    np.testing.assert_array_equal(pid, ppid)
    np.testing.assert_array_equal(g1, p1)
    np.testing.assert_array_equal(g2, p2)
  np.testing.assert_array_equal(tp.con_dim, te.con_dim)


def test_equal_static_tables_compare_without_rehashing(monkeypatch):
  """Two Models of one scene have equal but distinct static tables. Every
  cache keyed on them (the kernels' trees, the constraint layout) compares
  the two on each lookup, so the comparison must not digest the arrays
  again: that made every substep of a second Model several times slower on
  the host."""
  from mjlab_torch.physics import types
  arrays = g1_flat_arrays()
  a, b = tio.model_static(arrays), tio.model_static(arrays)
  assert a is not b and a == b and hash(a) == hash(b)
  assert a.pairs == b.pairs

  def no_digest(x):
    raise AssertionError('static tables digested again')

  monkeypatch.setattr(types, '_digest', no_digest)
  assert a == b and a.pairs == b.pairs and len({a, b}) == 1
  c = tio.model_static(arrays, ncon_cap=16)
  monkeypatch.undo()
  assert c != a


def test_tracking_scene_has_the_g1_flat_widths():
  """G1 tracking's compiled scene has G1 velocity's static widths (533
  candidate slots, caps 32 + 16, 144 contact rows; nv 35), so the Newton
  kernel's shared-memory fit rule takes it as it takes G1 flat."""
  from mjlab_tpu.scene.scene import Scene
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.physics.constraint import efc_layout
  cfg = jreg.load_cfg('Mjlab-Tracking-Flat-Unitree-G1')
  scene = Scene(cfg.scene)
  cfg.sim.mujoco.edit_spec(scene.spec)
  widths = []
  for mj in (scene.compile(), g1_flat_mjmodel()):
    s = tphys.put_model(mj, device='cpu').stat
    lay = efc_layout(s)
    widths.append((s.nv, s.pairs.ncon_max, s.ncon_cap, s.ncon_cap1, lay.ncr,
                   lay.nefc))
  assert widths[0] == widths[1] == (35, 533, 32, 16, 144, 208)
