"""Per-env model fields (domain randomization) in the port against the JAX
package, float64:

* one physics step of the G1 flat model (3 envs dropped onto the floor)
  with all 18 fields of FIELD_SPECS carrying an env axis, against
  `jax.vmap(pipeline.step, in_axes=(model_vmap_axes(...), 0))`: in each
  case one field's values differ across envs, then all of them at once;
* the plain version of K3 with per-env constants against the Pallas
  kernel itself in interpret mode (`smooth_fused._fused_batched`) on
  TinyBot, every segment of its float table per env.
Every case expands every field, so the JAX step compiles once. The env in
the shape of BASELINE config 5 is held to the JAX env in
test_torch_per_env_env.py, a file of its own so that another worker runs
it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import pipeline as jpipe
from mjlab_tpu.physics import smooth_fused as jsf
from mjlab_tpu.sim import sim as jsim
from mjlab_torch.envs.mdp.events import FIELD_SPECS
from mjlab_torch.ops import smooth_kernel as tsk
from mjlab_torch.physics import smooth_fused as tsf
from mjlab_torch.sim.sim import PER_ENV_FIELDS, expand_model_fields
from torch_parity import (
    data_leaves,
    g1_flat_mjmodel,
    g1_states,
    jax_batch,
    model_leaves,
    tiny_bot_mjmodel,
)

N = 3
STEP_TOL = 1e-9  # float64; the same formulas in another summation order
SMOOTH_TOL = 1e-10  # as tests/test_torch_smooth.py
FIELDS = sorted(FIELD_SPECS)
STEP_OUT = ('qpos', 'qvel', 'qacc', 'efc_force', 'sensordata', 'qM',
            'qfrc_bias', 'qfrc_passive', 'geom_xpos', 'geom_xmat',
            'site_xpos', 'site_xmat', 'subtree_com', 'cinr')


def _turn(q, rng, size=0.03):
  """Unit quaternions `q` turned by a few degrees."""
  q = q + size * rng.normal(size=q.shape)
  return q / np.linalg.norm(q, axis=-1, keepdims=True)


def perturb(field, base, rng, mj=None):
  """Distinct per-env values of `field` from its env-expanded compiled
  values `base` (numpy, (N, ...)). Joint ranges close in on the keyframe
  so that some limit rows turn active; friction loss and stiffness, zero
  on the G1, get positive values."""
  u = lambda lo, hi: rng.uniform(lo, hi, base.shape)
  if field in ('dof_armature', 'dof_damping'):
    return base * u(0.8, 1.2) + u(0.0, 0.02)
  if field in ('body_mass', 'body_inertia'):
    return base * u(0.8, 1.2)
  if field in ('body_pos', 'body_ipos', 'geom_pos', 'site_pos'):
    return base + u(-0.01, 0.01)
  if field.endswith('quat'):
    return _turn(base, rng)
  if field == 'qpos0':
    return base + u(-0.01, 0.01)
  if field == 'dof_frictionloss':
    return u(0.0, 0.3)
  if field == 'jnt_stiffness':
    return u(0.0, 5.0)
  if field == 'geom_friction':
    return base * u(0.5, 1.5)
  if field == 'geom_rgba':
    return u(0.0, 1.0)
  if field == 'jnt_range':
    key = np.asarray(mj.key_qpos[0])[np.asarray(mj.jnt_qposadr)]
    f = rng.uniform(0.5, 1.05, base.shape[:-1])
    out = base.copy()
    out[..., 0] = base[..., 0] + f * (key - base[..., 0])
    out[..., 1] = base[..., 1] - f * (base[..., 1] - key)
    return out
  raise ValueError(field)


@pytest.fixture(scope='module')
def g1():
  """The G1 flat model with every field of FIELD_SPECS env-expanded, in
  the JAX package's terms: (mj, the expanded JAX Model, a JAX Data of 3
  envs, the jitted step vmapped over the env axis of every field)."""
  mj = g1_flat_mjmodel()
  jm = jio.put_model(mj, dtype=jnp.float64)
  jme = jsim.expand_model_fields(jm, FIELDS, N)
  axes = jsim.model_vmap_axes(jme, jm)
  jd = jax_batch(jm, N, *g1_states(mj, N, seed=0, drop=0.03))
  step = jax.jit(jax.vmap(jpipe.step, in_axes=(axes, 0)))
  return mj, jme, jd, step


def _port_model(mj, jme):
  stat = tphys.put_model(mj, device='cpu', dtype=torch.float64).stat
  return tphys.model_from_numpy(model_leaves(jme), stat, device='cpu',
                                dtype=torch.float64)


def _with(jme, values):
  return jme.replace(**{f: jnp.asarray(v) for f, v in values.items()})


def _close(got, want, tol, what):
  got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def test_every_field_is_per_env():
  assert set(PER_ENV_FIELDS) == set(FIELD_SPECS) and len(FIELDS) == 18
  m = tphys.put_model(g1_flat_mjmodel(), device='cpu')
  e = expand_model_fields(m, FIELDS, N)
  # the static tables are the base model's own object: keyed caches on
  # them (lru_cache over ModelStatic) are not digested anew
  assert e.stat is m.stat and e.device == m.device and e.dtype == m.dtype
  for f in FIELDS:
    assert getattr(e, f).shape == (N,) + getattr(m, f).shape, f
  with pytest.raises(NotImplementedError, match='12.11'):
    expand_model_fields(m, ['actuator_gear'], N)


@pytest.mark.parametrize('field', FIELDS + ['all'])
def test_step_with_per_env_field_matches_jax(g1, field):
  mj, jme, jd, step = g1
  rng = np.random.default_rng(FIELDS.index(field) if field in FIELDS else 99)
  names = FIELDS if field == 'all' else [field]
  values = {f: perturb(f, np.asarray(getattr(jme, f)), rng, mj)
            for f in names}
  for f, v in values.items():
    assert not np.array_equal(v[0], v[1]), f'{f}: envs 0 and 1 agree'
  jcase = _with(jme, values)
  want = step(jcase, jd)
  tm = _port_model(mj, jcase)
  for f in PER_ENV_FIELDS:
    assert getattr(tm, f).shape[0] == N, f
  td = tphys.data_from_numpy(data_leaves(jd), tm)
  got = tphys.step(tm, td)
  for f in STEP_OUT:
    _close(getattr(got, f), getattr(want, f), STEP_TOL, f'{field}: {f}')
  assert np.asarray(jd.qpos).shape == (N, mj.nq)
  if field == 'geom_rgba':
    return
  # the field is read: the step moves away from the compiled model's
  base = tphys.step(_port_model(mj, jme), td)
  moved = max(float((getattr(got, f) - getattr(base, f)).abs().max())
              for f in STEP_OUT)
  assert moved > 1e-6, f'{field} does not change the step'


def test_plain_k3_per_env_matches_pallas_interpret_tiny_bot():
  """K3's function with per-env constants: every segment of its float table
  (the body, joint, geom and site constants, qpos0 and armature) differs
  across envs; the Pallas kernel takes them batched on axis 0."""
  mj = tiny_bot_mjmodel()
  n = 2  # no shared leaf of TinyBot is 2 long on axis 0
  jm = jio.put_model(mj, dtype=jnp.float64)
  rng = np.random.default_rng(5)
  fields = tsk.FLOAT_TABLE_FIELDS
  jme = jsim.expand_model_fields(jm, fields, n)
  values = {}
  for f in fields:
    base = np.asarray(getattr(jme, f))
    values[f] = (base + rng.uniform(-0.02, 0.02, base.shape)
                 if f in ('jnt_pos', 'jnt_axis')
                 else perturb(f, base, rng, mj))
  jme = _with(jme, values)
  qpos = np.tile(mj.qpos0, (n, 1))
  qpos[:, 2] += 0.1
  qpos[:, 7:] += 0.3 * rng.normal(size=(n, mj.nq - 7))
  qvel = rng.normal(size=(n, mj.nv))
  qvel[:, 3:6] = [0.7, -0.4, 0.9]  # the free joint's segment rule
  jd = jax_batch(jm, n, qpos, qvel, np.zeros((n, mj.nu)))
  want = jsf._fused_batched(jme, jd, interpret=True)
  tm = _port_model(mj, jme)
  td = tphys.data_from_numpy(data_leaves(jd), tm)
  plan = tsk.plan_of(tm)
  assert plan.env_batch == n and plan.dims[15] == 0b111111
  got = tsf.smooth_all(tm, td)
  for f in ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'xanchor', 'xaxis',
            'geom_xpos', 'geom_xmat', 'site_xpos', 'site_xmat',
            'subtree_com', 'cinr', 'cdof', 'cvel', 'cdof_dot', 'qM',
            'qfrc_bias'):
    _close(getattr(got, f), getattr(want, f), SMOOTH_TOL, f)
  # the per-env constants matter: env 1 under env 0's model differs
  swapped = tsf.plain_all(
      tm.replace(**{f: getattr(tm, f)[[0, 0]] for f in fields}), td)
  assert float((swapped.qM[1] - got.qM[1]).abs().max()) > 1e-6
