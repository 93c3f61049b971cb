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
from chip_smoke import degenerate_ranges

# The parity tests run a few envs: every op is tiny, and PyTorch's pool of
# intra-op threads only spins on them, slower than one thread alone and in
# the way of the other test workers on the same cores.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=1)
def g1_flat_mjmodel():
  """The MjModel `Mjlab-Velocity-Flat-Unitree-G1` builds (JAX package)."""
  from mjlab_tpu.scene.scene import Scene
  from mjlab_tpu.tasks import registry
  cfg = registry.load_cfg('Mjlab-Velocity-Flat-Unitree-G1')
  scene = Scene(cfg.scene)
  cfg.sim.mujoco.edit_spec(scene.spec)
  return scene.compile()


@functools.lru_cache(maxsize=1)
def g1_tracking_mjmodel():
  """The MjModel `Mjlab-Tracking-Flat-Unitree-G1` builds (JAX package),
  visual meshes included."""
  from mjlab_tpu.scene.scene import Scene
  from mjlab_tpu.tasks import registry
  cfg = registry.load_cfg('Mjlab-Tracking-Flat-Unitree-G1')
  scene = Scene(cfg.scene)
  cfg.sim.mujoco.edit_spec(scene.spec)
  return scene.compile()


@functools.lru_cache(maxsize=1)
def go1_flat_mjmodel():
  """The MjModel `Mjlab-Velocity-Flat-Unitree-Go1` builds (JAX package),
  visual meshes included."""
  from mjlab_tpu.scene.scene import Scene
  from mjlab_tpu.tasks import registry
  cfg = registry.load_cfg('Mjlab-Velocity-Flat-Unitree-Go1')
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


# ---------------------------------------------------------------------------
# the environment layer
# ---------------------------------------------------------------------------

G1_FLAT_TASK = 'Mjlab-Velocity-Flat-Unitree-G1'


# XLA:CPU compile options for the JAX side of a parity test: the backend's
# optimization and the fusion emitters off. The programs compute the same
# functions, and compile about three times faster on one core (a Tiny env's
# reset, 26 s against 8 s); what runs after the compile is a few steps.
QUICK_COMPILE = {'xla_backend_optimization_level': 0,
                 'xla_cpu_use_fusion_emitters': False}


def quick_jit(fn, **kw):
  """jax.jit with QUICK_COMPILE."""
  return jax.jit(fn, compiler_options=QUICK_COMPILE, **kw)


def jax_env_f64(cfg, quick: bool = False):
  """The JAX package's env with a float64 Model and Data. Its Scene and its
  batched Data default to float32 whatever jax_enable_x64 says; a parity
  test at 1e-6 over contact dynamics needs both sides in float64. `quick`
  compiles its reset and step with QUICK_COMPILE."""
  from unittest import mock

  from mjlab_tpu.envs import manager_based_rl_env as jenv
  f64_scene = functools.partial(jenv.Scene, dtype=jnp.float64)
  f64_data = functools.partial(jenv.make_batched_data, dtype=jnp.float64)
  with mock.patch.object(jenv, 'Scene', f64_scene), \
       mock.patch.object(jenv, 'make_batched_data', f64_data):
    env = jenv.ManagerBasedRlEnv(cfg)
  if quick:
    env._step_jit = quick_jit(env._step_fn, donate_argnums=(0,))
    env._reset_jit = quick_jit(env._reset_fn)
  return env


def g1_env_pair(num_envs, degenerate=True, task=G1_FLAT_TASK):
  """(JAX env, port env) of a velocity task (G1 flat unless `task` names
  another) on one compiled model, both float64; the port's on the CPU."""
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.tasks import registry as treg
  edit = degenerate_ranges if degenerate else (
      lambda c, n: setattr(c.scene, 'num_envs', n) or c)
  jenv = jax_env_f64(edit(jreg.load_cfg(task), num_envs))
  tenv = treg.make(task, cfg=edit(treg.load_cfg(task), num_envs),
                   device='cpu', dtype=torch.float64,
                   mj_model=jenv.scene.mj_model)
  return jenv, tenv


def _np_tree(x):
  if isinstance(x, dict):
    return {k: _np_tree(v) for k, v in x.items()}
  if dataclasses.is_dataclass(x):
    return {f.name: _np_tree(getattr(x, f.name))
            for f in dataclasses.fields(x)}
  return np.asarray(x)


def env_state_leaves(jstate, per_env_fields=('geom_friction',)) -> dict:
  """JAX EnvState -> the dict of numpy leaves that
  mjlab_torch.envs.io.env_state_from_numpy takes."""
  out = {k: _np_tree(getattr(jstate, k)) for k in (
      'episode_length', 'common_step', 'actions', 'prev_actions',
      'reward_sums', 'command', 'obs', 'event', 'curriculum', 'reward')}
  out['data'] = data_leaves(jstate.data)
  out['model'] = {k: np.asarray(getattr(jstate.model, k))
                  for k in per_env_fields}
  return out


def _jnp_like(template, x):
  if isinstance(template, dict):
    return {k: _jnp_like(v, x[k]) for k, v in template.items()}
  if dataclasses.is_dataclass(template):
    return template.replace(**{
        f.name: _jnp_like(getattr(template, f.name), x[f.name])
        for f in dataclasses.fields(template)
        if getattr(template, f.name) is not None and f.name in x})
  return jnp.asarray(x, jnp.asarray(template).dtype).reshape(
      jnp.shape(template))


def jax_data_from_leaves(template, leaves):
  """A batched JAX Data like `template` holding the port's Data leaves (the
  dict of mjlab_torch.envs.io.env_state_to_numpy's 'data'); fields the port
  does not have keep the template's values."""
  return _jnp_like(template, leaves)


def jax_state_from_leaves(jenv, arrays):
  """The JAX env's EnvState holding the numpy leaves of
  mjlab_torch.envs.io.env_state_to_numpy (the way back of
  env_state_leaves)."""
  t = jenv._template_state
  jd = jax_data_from_leaves(t.data, arrays['data'])
  jm = t.model.replace(**{k: jnp.asarray(v)
                          for k, v in arrays['model'].items()})
  rest = {k: _jnp_like(getattr(t, k), arrays[k]) for k in (
      'episode_length', 'common_step', 'actions', 'prev_actions',
      'reward_sums', 'command', 'obs', 'event', 'curriculum', 'reward')}
  return t.replace(model=jm, data=jd, **rest)
