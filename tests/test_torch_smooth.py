"""Parity of the port's fused smooth stage (the plain version of kernel K3,
mjlab_torch/physics/smooth_fused.py:plain_all) with the JAX package: the
XLA stages it fuses (smooth_fused._xla_all) on the G1 flat model, and the
Pallas kernel itself in interpret mode (smooth_fused._fused_batched) on
TinyBot, whose small tree keeps interpret mode fast. States carry a
nonzero free-joint angular velocity, which exercises the joint-segment
rule of cdof_dot (mjlab_tpu/ops/smooth_kernel.py:385-392)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import smooth_fused as jsf
from mjlab_torch.physics import pipeline as tpipe
from mjlab_torch.physics import smooth_fused as tsf
from torch_parity import (
    g1_flat_mjmodel,
    g1_states,
    jax_batch,
    tiny_bot_mjmodel,
    to_port,
)

FIELDS = ('xpos', 'xquat', 'xmat', 'xipos', 'ximat', 'xanchor', 'xaxis',
          'geom_xpos', 'geom_xmat', 'site_xpos', 'site_xmat', 'subtree_com',
          'cinr', 'cdof', 'cvel', 'cdof_dot', 'qM', 'qfrc_bias')
TOL = 1e-10  # float64 on both sides; same formulas, other summation order


def _tiny_states(mj, n, seed):
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (n, 1))
  qpos[:, 2] += 0.1
  qpos[:, 3:7] += 0.05 * rng.normal(size=(n, 4))
  qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=-1, keepdims=True)
  qpos[:, 7:] += 0.3 * rng.normal(size=(n, mj.nq - 7))
  return qpos, rng.normal(size=(n, mj.nv)), np.zeros((n, mj.nu))


def _setup(mj, make_states, n=2, seed=0):
  jm = jio.put_model(mj, dtype=jnp.float64)
  qpos, qvel, ctrl = make_states(mj, n, seed)
  qvel[:, 3:6] = np.array([0.7, -0.4, 0.9])  # free-joint angular velocity
  jd = jax_batch(jm, n, qpos, qvel, ctrl)
  tm, td = to_port(jm, jd, mj)
  return jm, jd, tm, td


def _assert_fields(port, ref, tol):
  for f in FIELDS:
    got = getattr(port, f).numpy()
    want = np.asarray(getattr(ref, f))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=f)


def test_plain_matches_xla_stages_g1_flat():
  jm, jd, tm, td = _setup(g1_flat_mjmodel(), g1_states)
  ref = jax.jit(jax.vmap(jsf._xla_all, in_axes=(None, 0)))(jm, jd)
  got = tsf.plain_all(tm, td)
  _assert_fields(got, ref, TOL)
  # the CPU dispatch runs the plain version, and the pipeline uses it
  assert tsf.enabled(tm.stat)
  via = tpipe.fwd_velocity(tm, tpipe.fwd_position(tm, td))
  _assert_fields(via, ref, TOL)


def test_plain_matches_pallas_interpret_tiny_bot():
  jm, jd, tm, td = _setup(tiny_bot_mjmodel(), _tiny_states)
  ref = jsf._fused_batched(jm, jd, interpret=True)
  got = tsf.smooth_all(tm, td)
  _assert_fields(got, ref, TOL)
  # and the same against the XLA stages on this model
  _assert_fields(got, jax.vmap(jsf._xla_all, in_axes=(None, 0))(jm, jd),
                 TOL)
  assert torch.all(td.qvel[:, 3:6] != 0)
