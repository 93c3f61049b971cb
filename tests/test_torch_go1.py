"""The Unitree Go1 flat velocity task in the port against the JAX package:
the scene the port builds (and its committed snapshot) against the model
the JAX env compiles, the plane-box collider in float64, one physics step
with trunks lying on the floor, and six env-steps of
`Mjlab-Velocity-Flat-Unitree-Go1` under the degenerate-range
configuration; the task's scripts (list_envs, demo) on the CPU. K1-K3 at
the Go1's shapes are held on the card by tests/test_torch_kernels.py
(marked cuda) and chip_smoke.py phase 2e."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from chip_smoke import go1_floor_states
from mjlab_tpu.physics import collision as jcol
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import pipeline as jpipe
import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import GO1_FLAT, go1_flat_arrays
from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.physics import collision as tcol
from mjlab_torch.physics import constraint as tcon
from mjlab_torch.physics import io as tio
from mjlab_torch.physics.types import GeomType
from mjlab_torch.rl import onnx_writer
from mjlab_torch.scene import snapshot as tsnap
from torch_parity import env_state_leaves, g1_env_pair, go1_flat_mjmodel
from torch_parity import jax_batch, to_port

GO1_TASK = 'Mjlab-Velocity-Flat-Unitree-Go1'
BOX_KEY = (int(GeomType.PLANE), int(GeomType.BOX))


def _names(m, objtype, ids):
  return [mujoco.mj_id2name(m, objtype, int(i)) for i in ids]


def test_snapshot_matches_fresh_compile():
  """The committed Go1 flat snapshot is the scene builder's output, the
  spec inputs it records included."""
  fresh = tsnap.snapshot(GO1_FLAT).arrays()
  saved = go1_flat_arrays().arrays()
  assert sorted(fresh) == sorted(saved)
  for k in fresh:
    np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)
  a = tphys.put_model(go1_flat_arrays(), device='cpu')
  b = tphys.put_model(tsnap.model(GO1_FLAT), device='cpu')
  assert a.stat == b.stat
  for f in tio.MODEL_FIELDS:
    assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_go1_flat_scene_matches_jax_env():
  """Every physics field of the port's scene equals the velocity env's,
  all 43 geoms (the 12 visual mesh geoms among them) compared by id, and
  the same static pair table: 57
  uncompacted slots, all condim 3, plane-sphere, plane-capsule and one
  plane-box pair."""
  port, env = tsnap.model(GO1_FLAT), go1_flat_mjmodel()
  for f in ('nq', 'nv', 'nu', 'nbody', 'njnt', 'nsensor', 'nsensordata',
            'nkey'):
    assert getattr(port, f) == getattr(env, f), f
  assert (port.nq, port.nv, port.nu, port.nbody) == (19, 18, 12, 14)
  prefixes = ('body_', 'jnt_', 'dof_', 'actuator_', 'sensor_')
  for f in tio.SNAPSHOT_ARRAYS:  # the fields the engine reads
    if f.startswith(prefixes):
      np.testing.assert_allclose(getattr(port, f), getattr(env, f),
                                 rtol=1e-12, atol=1e-12, err_msg=f)
  geom = mujoco.mjtObj.mjOBJ_GEOM
  assert (port.sensor_objtype == geom).all()
  assert _names(port, geom, port.sensor_objid) == _names(
      env, geom, env.sensor_objid) == [
          f'robot/{p}_foot_collision' for p in ('FL', 'FR', 'RL', 'RR')]
  assert port.ngeom == env.ngeom == 43
  assert (port.geom_group == 2).sum() == 12
  for f in ('geom_type', 'geom_bodyid', 'geom_size', 'geom_pos',
            'geom_quat', 'geom_friction', 'geom_condim', 'geom_priority',
            'geom_contype', 'geom_conaffinity', 'geom_solref',
            'geom_solimp', 'geom_solmix', 'geom_margin', 'geom_gap',
            'geom_group', 'geom_dataid'):
    np.testing.assert_array_equal(getattr(port, f), getattr(env, f),
                                  err_msg=f)
  assert _names(port, geom, range(port.ngeom)) == _names(
      env, geom, range(env.ngeom))
  for f in ('timestep', 'integrator', 'cone', 'iterations', 'ls_iterations',
            'tolerance', 'ls_tolerance', 'impratio', 'gravity'):
    np.testing.assert_array_equal(getattr(port.opt, f), getattr(env.opt, f),
                                  err_msg=f'opt.{f}')
  np.testing.assert_array_equal(port.key_qpos, env.key_qpos)
  np.testing.assert_array_equal(port.key_ctrl, env.key_ctrl)
  np.testing.assert_allclose(port.stat.meaninertia, env.stat.meaninertia,
                             rtol=1e-12)
  tp = tphys.put_model(port, device='cpu').stat
  te = tphys.put_model(env, device='cpu').stat
  assert (tp.pairs.ncon_max, tp.ncon_cap, tp.ncon_cap1) == (
      te.pairs.ncon_max, te.ncon_cap, te.ncon_cap1) == (57, 0, 0)
  assert sorted(tp.pairs.groups) == sorted(te.pairs.groups)
  assert {k: len(v[0]) for k, v in tp.pairs.groups.items()} == {
      (int(GeomType.PLANE), int(GeomType.SPHERE)): 5,
      (int(GeomType.PLANE), int(GeomType.CAPSULE)): 24, BOX_KEY: 1}
  for key, (g1, g2, pid, base, npts) in te.pairs.groups.items():
    p1, p2, ppid, pbase, pnpts = tp.pairs.groups[key]
    assert (base, npts) == (pbase, pnpts)
    np.testing.assert_array_equal(pid, ppid)
    np.testing.assert_array_equal(g1, p1)
    np.testing.assert_array_equal(g2, p2)
  np.testing.assert_array_equal(tp.con_dim, te.con_dim)
  assert (np.asarray(tp.con_dim) == 3).all()
  lay = tcon.efc_layout(tp)
  assert (lay.nefc, lay.nf, len(lay.limit_jnt), lay.ncr) == (258, 18, 12,
                                                            228)


def _box_case(kind: str, rng):
  """A plane and a box (half sizes 0.13, 0.09, 0.05) in `kind` poses:
  tilted into the plane, lying flat 2 mm deep (turned about z only, so its
  four lowest corners are at one depth), or above the plane."""
  def rot(axis, angle):
    q = np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])
    m = np.zeros(9)
    mujoco.mju_quat2Mat(m, q)
    return m.reshape(3, 3)

  n = 4
  p1 = np.zeros((n, 3))
  p1[:, :2] = rng.normal(size=(n, 2))
  m1 = np.tile(np.eye(3), (n, 1, 1))
  s1 = np.tile([0.0, 0.0, 0.05], (n, 1))
  s2 = np.tile([0.13, 0.09, 0.05], (n, 1))
  p2 = np.zeros((n, 3))
  p2[:, :2] = rng.normal(size=(n, 2))
  yaw = [rot(np.array([0, 0, 1.0]), a) for a in rng.uniform(-3, 3, n)]
  if kind == 'tilted':
    m1[1] = rot(np.array([1.0, 0, 0]), 0.2)  # a tilted plane too
    m2 = np.stack([y @ rot(np.array([1.0, 1.0, 0]) / np.sqrt(2), 0.3)
                   for y in yaw])
    p2[:, 2] = 0.06
  elif kind == 'flat':
    m2 = np.stack(yaw)
    p2[:, 2] = 0.048
  else:
    m2 = np.stack([y @ rot(np.array([0, 1.0, 0]), 0.4) for y in yaw])
    p2[:, 2] = 0.5
  return p1, m1, s1, p2, m2, s2


@pytest.mark.parametrize('kind', ['tilted', 'flat', 'above'])
def test_plane_box_matches_jax(kind):
  args = _box_case(kind, np.random.default_rng(['tilted', 'flat',
                                                'above'].index(kind)))
  want = jcol._plane_box(*(jnp.asarray(a) for a in args))
  got = tcol._plane_box(*(torch.as_tensor(a) for a in args))
  assert len(got) == len(want) == 3
  for g, w, name in zip(got, want, ('dist', 'pos', 'normal')):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12,
                               err_msg=name)
  dist = got[0].numpy()
  if kind == 'flat':
    np.testing.assert_allclose(dist, -0.002, atol=1e-15)
    # the stable sort keeps the corners' order: x -, then x +, y - first
    np.testing.assert_array_equal(
        np.sign(np.einsum('nij,nkj->nki', args[4].transpose(0, 2, 1),
                          got[1].numpy() - args[3][:, None]))[..., :2],
        np.tile([[-1, -1], [-1, 1], [1, -1], [1, 1]], (4, 1, 1)))
  elif kind == 'above':
    assert (dist > 0.3).all()
  else:
    assert (dist.min(-1) < 0).all()


@functools.cache
def _jax_step():
  return jax.jit(jax.vmap(jpipe.step, in_axes=(None, 0)))


def test_step_with_trunks_on_the_floor_matches_jax():
  """One physics step of six Go1 envs (trunks flat and tilted on the
  floor, and standing) against the JAX package in float64, with the
  plane-box slots active."""
  mj = go1_flat_mjmodel()
  jm = jio.put_model(mj, dtype=jnp.float64)
  qpos, qvel = go1_floor_states(mj.key_qpos[0], mj.nv, 6, seed=0)
  ctrl = np.tile(mj.key_ctrl[0], (6, 1))
  jd = jax_batch(jm, 6, qpos, qvel, ctrl)
  tm, td = to_port(jm, jd, mj)
  want = _jax_step()(jm, jd)
  got = tphys.step(tm, td)
  for f in ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata',
            'ncon_active'):
    np.testing.assert_allclose(getattr(got, f).numpy(),
                               np.asarray(getattr(want, f)), rtol=0,
                               atol=1e-9, err_msg=f)
  base = tm.stat.pairs.groups[BOX_KEY][3]
  c = got.contact
  box = (c.dist < c.includemargin)[:, base:base + 4]
  assert box.all(-1).any() and box.any(-1).sum() == 4


N = 2
TOL = 1e-6  # 24 substeps of contact dynamics amplify float64 roundoff
STEPS = 6
TIP_AT = 2


def _close(got, want, what, tol=TOL):
  got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0, atol=tol,
                               err_msg=what)


def _same_tree(got, want, path):
  for k, v in got.items():
    if isinstance(v, dict):
      _same_tree(v, want[k], f'{path}/{k}')
    else:
      _close(v, want[k], f'{path}/{k}')


def test_six_env_steps_match_jax():
  """Reset and six env-steps of the Go1 flat task against the JAX env,
  both float64 on one compiled model, every sampling range collapsed to a
  point: observations, rewards, done flags, extras and every leaf of the
  state within 1e-6, with env 1 tipped over before the third step (a
  masked reset and the refresh) and the command-velocity curriculum on."""
  jenv, tenv = g1_env_pair(N, task=GO1_TASK)
  assert tenv.cfg.curriculum.command_vel is not None
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  for g in ('policy', 'critic'):
    _close(tobs[g], jobs[g], f'reset obs {g}', 1e-12)
    assert tobs[g].shape == (N, 48)
  _same_tree(env_state_to_numpy(tenv.state, tenv),
             env_state_leaves(jenv.state), 'reset state')
  feet = tenv.state.model.geom_friction[:, :, 0] == 0.45
  assert int(feet.sum()) == N * 4
  rng = np.random.default_rng(0)
  fired = []
  for i in range(STEPS):
    act = 0.3 * rng.normal(size=(N, 12))
    if i == TIP_AT:
      qpos = np.asarray(jenv.state.data.qpos).copy()
      half = np.radians(80.0) / 2
      qpos[1, 3:7] = [np.cos(half), np.sin(half), 0.0, 0.0]
      js, ts = jenv.state, tenv.state
      jenv._state = js.replace(data=js.data.replace(qpos=jnp.asarray(qpos)))
      tenv._state = ts.replace(
          data=ts.data.replace(qpos=torch.as_tensor(qpos)))
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(torch.as_tensor(act))
    what = f'step {i}'
    for g in ('policy', 'critic'):
      _close(tout[0][g], jout[0][g], f'{what} obs {g}')
    for k, name in ((1, 'reward'), (2, 'terminated'), (3, 'truncated')):
      _close(tout[k], jout[k], f'{what} {name}')
    assert set(tout[4]) == set(jout[4]), what
    _same_tree(tout[4], jout[4], f'{what} extras')
    _same_tree(env_state_to_numpy(tenv.state, tenv),
               env_state_leaves(jenv.state), f'{what} state')
    fired.append(tout[2].tolist())
  assert fired == [[False, i == TIP_AT] for i in range(STEPS)]
  assert float(tenv.state.data.qpos[1, 2]) > 0.2


def test_list_envs_lists_the_go1_tasks(capsys):
  from mjlab_torch.scripts import list_envs
  tasks = list_envs.main([])
  assert {GO1_TASK, GO1_TASK + '-Play'} <= set(tasks)
  assert GO1_TASK + '-Play' in capsys.readouterr().out


def test_demo_trains_exports_and_plays(tmp_path):
  """With no checkpoint under the log root and no shipped Go1 policy, the
  demo trains, every save exports the ONNX beside the checkpoint, and the
  trained policy plays; a second demo finds the checkpoint and plays it
  without training."""
  from mjlab_torch.scripts import demo
  small = ['--agent.num_steps_per_env', '2',
           '--agent.policy.actor_hidden_dims', '(16, 16)',
           '--agent.policy.critic_hidden_dims', '(16,)']
  argv = ['--device', 'cpu', '--log-root', str(tmp_path), '--num-envs', '2',
          '--train-iterations', '1', '--steps', '3'] + small
  out = demo.main(argv)
  run = tmp_path / 'go1_flat' / 'demo'
  assert out['checkpoint'] == str(run / 'model_1.pt')
  assert (run / 'model_1.onnx').exists()
  with open(run / 'model_1.onnx.meta.json') as f:
    meta = json.load(f)
  runner = out['runner']
  term = runner.env.action_manager.terms['joint_pos']
  assert meta['joint_names'] == list(term.joint_names)
  assert len(meta['joint_names']) == 12
  obs = runner.ts.obs
  want = runner.get_inference_policy()(obs).numpy()
  got = onnx_writer.run_mlp_policy(
      onnx_writer.parse_model(str(run / 'model_1.onnx')),
      obs['policy'].numpy())
  assert np.abs(got - want).max() <= 1e-6 * (1 + np.abs(want).max())
  assert np.isfinite(out['play']['mean_reward'])
  again = demo.main(argv)
  assert again['runner'] is None
  assert again['checkpoint'] == out['checkpoint']
  assert sorted(os.listdir(tmp_path / 'go1_flat')) == ['demo']
