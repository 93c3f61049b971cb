"""Shared fixtures of the port's parity tests (tests/test_torch_*.py): the
JAX velocity env's own G1 flat MjModel, and numpy carry-across of the JAX
package's Model / Data leaves into the port's tensors."""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mjlab_torch.physics as tphys


@functools.lru_cache(maxsize=1)
def g1_flat_mjmodel():
  """The MjModel `Mjlab-Velocity-Flat-Unitree-G1` builds (JAX package)."""
  from mjlab_tpu.scene.scene import Scene
  from mjlab_tpu.tasks import registry
  cfg = registry.load_cfg('Mjlab-Velocity-Flat-Unitree-G1')
  scene = Scene(cfg.scene)
  cfg.sim.mujoco.edit_spec(scene.spec)
  return scene.compile()


def model_leaves(jm) -> dict:
  """JAX Model -> dict of numpy leaves (with 'opt' nested)."""
  out = {f.name: np.asarray(getattr(jm, f.name))
         for f in dataclasses.fields(jm)
         if f.name not in ('stat', 'opt') and getattr(jm, f.name) is not None}
  out['opt'] = {f.name: np.asarray(getattr(jm.opt, f.name))
                for f in dataclasses.fields(jm.opt)}
  return out


def data_leaves(jd) -> dict:
  """Batched JAX Data -> dict of numpy leaves (with 'contact' nested)."""
  out = {f.name: np.asarray(getattr(jd, f.name))
         for f in dataclasses.fields(jd)
         if f.name != 'contact' and getattr(jd, f.name) is not None}
  out['contact'] = {f.name: np.asarray(getattr(jd.contact, f.name))
                    for f in dataclasses.fields(jd.contact)}
  return out


def to_port(jm, jd, mj):
  """The port's Model and Data holding the JAX package's values."""
  stat = tphys.put_model(mj, device='cpu', dtype=torch.float64).stat
  tm = tphys.model_from_numpy(model_leaves(jm), stat, device='cpu',
                              dtype=torch.float64)
  return tm, tphys.data_from_numpy(data_leaves(jd), tm)


def jax_batch(jm, n, qpos, qvel, ctrl):
  """A batched JAX Data (float64) at the given numpy state."""
  from mjlab_tpu.physics import io
  d = io.make_data(jm, dtype=jnp.float64)
  d = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape).copy(), d)
  # ncon_active as the step returns it, so one compiled step serves both
  return d.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                   ctrl=jnp.asarray(ctrl),
                   ncon_active=d.ncon_active.astype(jnp.int64))


def g1_states(mj, n, seed, drop=0.0, qpos_noise=0.05, qvel_scale=0.5):
  """Seeded G1 states near the keyframe: joint noise, a unit root quat,
  random velocities; `drop` lowers the root so the feet touch the floor."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.key_qpos[0], (n, 1))
  qpos[:, 7:] += qpos_noise * rng.normal(size=(n, mj.nq - 7))
  qpos[:, 3:7] += 0.02 * rng.normal(size=(n, 4))
  qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=-1, keepdims=True)
  qpos[:, 2] -= drop
  qvel = qvel_scale * rng.normal(size=(n, mj.nv))
  ctrl = np.tile(mj.key_ctrl[0], (n, 1)) + 0.1 * rng.normal(size=(n, mj.nu))
  return qpos, qvel, ctrl


def random_newton_problem(B, n, ncr, nl, seed=0, dtype=np.float64):
  """Random structured Newton inputs (the generator of
  tests/test_newton_kernel.py), as numpy arrays."""
  rng = np.random.default_rng(seed)
  A = rng.normal(size=(B, n, n)).astype(dtype) * 0.1
  M = A @ np.transpose(A, (0, 2, 1)) + np.eye(n, dtype=dtype) * 2.0
  a0 = rng.normal(size=(B, n)).astype(dtype)
  ws = a0 + 0.01 * rng.normal(size=(B, n)).astype(dtype)
  cJ = rng.normal(size=(B, ncr, n)).astype(dtype) * 0.5
  c_aref = rng.normal(size=(B, ncr)).astype(dtype)
  cD = np.abs(rng.normal(size=(B, ncr))).astype(dtype) * 20
  c_act = (rng.random(size=(B, ncr)) < 0.5).astype(dtype)
  l_sign = np.sign(rng.normal(size=(B, nl))).astype(dtype)
  l_aref = rng.normal(size=(B, nl)).astype(dtype)
  lD = np.abs(rng.normal(size=(B, nl))).astype(dtype) * 50
  l_act = (rng.random(size=(B, nl)) < 0.4).astype(dtype)
  f_aref = rng.normal(size=(B, n)).astype(dtype) * 0.1
  fD = np.abs(rng.normal(size=(B, n))).astype(dtype) * 30
  floss = np.abs(rng.normal(size=(B, n))).astype(dtype) * 2
  f_act = (rng.random(size=(B, n)) < 0.5).astype(dtype)
  return (M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD, l_act,
          f_aref, fD, floss, f_act)


def g1_newton_problem(n, seed=0, drop=0.03):
  """The port's own Newton inputs (float64, CPU) for `n` G1 flat envs
  dropped onto the floor: (args of newton_plain up to f_act, iterations,
  ls_polish, ldof, grad_th)."""
  from mjlab_torch.asset_zoo import g1_flat_arrays
  from mjlab_torch.physics import constraint, pipeline, smooth, solver
  mj = g1_flat_arrays()
  m = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  qpos, qvel, ctrl = g1_states(mj, n, seed, drop=drop)
  d = tphys.make_batched_data(m, n, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel),
      ctrl=torch.as_tensor(ctrl))
  d = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  d = smooth.fwd_smooth(m, smooth.actuation(m, d))
  efc = constraint.make_efc(m, d)
  args = [t.contiguous() for t in solver.newton_args(d, efc)]
  return (args,) + solver.solver_params(m.stat)


@functools.lru_cache(maxsize=1)
def tiny_bot_mjmodel():
  """The JAX package's TinyBot on a plane (small pair table: the contact
  rows take the uncompacted path)."""
  from mjlab_tpu.asset_zoo.tiny_bot import TINY_ROBOT_CFG
  from mjlab_tpu.scene.scene import Scene, SceneCfg
  from mjlab_tpu.terrains.importer import TerrainImporterCfg
  scene = Scene(SceneCfg(num_envs=1, terrain=TerrainImporterCfg(),
                         entities={'robot': TINY_ROBOT_CFG}))
  return scene.compile()
