"""Parity of the port's solver pieces with the JAX package: the plain
version of kernel K1 (physics/linalg.py:solve_pd) against the JAX
linalg.solve_pd, the plain version of kernel K2 (physics/solver.py:
newton_plain) against the JAX _newton_jax and the Pallas whole-solver kernel
in interpret mode (including its early exit), and the captured
linesearch-blowup state of tests/data/blowup_ls_fixture.npz. Then what
the K2 kernel's design relies on, shown on the plain solver with G1 flat
inputs: inactive contact rows can be dropped and rows reordered, and a
frozen env's result does not depend on the iteration cap."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.ops.newton import newton_solve_tpu
from mjlab_tpu.physics import linalg as jlinalg
from mjlab_tpu.physics import solver as jsolver
from mjlab_torch.ops import pd_solve as tpd
from mjlab_torch.physics import linalg as tlinalg
from mjlab_torch.physics import solver as tsolver
from torch_parity import g1_newton_problem, random_newton_problem

FIXTURE = os.path.join(os.path.dirname(__file__), 'data',
                       'blowup_ls_fixture.npz')
ARG_KEYS = ('M', 'a0', 'ws', 'cJ', 'c_aref', 'cD', 'c_act', 'l_sign',
            'l_aref', 'lD', 'l_act', 'f_aref', 'fD', 'floss', 'f_act')
LDOF = (2, 4, 6, 8)
MASKS = (6, 10, 14)  # positions of the activity masks in the argument list


def _torch_args(args):
  out = [torch.as_tensor(np.array(a)) for a in args]
  for i in MASKS:
    out[i] = out[i].bool()
  return out


def _jax_args(args):
  out = [jnp.asarray(a) for a in args]
  for i in MASKS:
    out[i] = out[i].astype(bool)
  return out


def _assert_scaled(got, want, atol, names=('qacc', 'ff', 'fl', 'fc')):
  for name, g, w in zip(names, got, want):
    g, w = np.asarray(g), np.asarray(w)
    scale = np.max(np.abs(w)) + 1.0
    np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=atol,
                               err_msg=name)


def test_pd_solve_matches_jax():
  rng = np.random.default_rng(0)
  B, n = 8, 35
  A = rng.normal(size=(B, n, n))
  H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(n)
  g = rng.normal(size=(B, n))
  want = np.asarray(
      jax.jit(jlinalg.solve_pd)(jnp.asarray(H), jnp.asarray(g)))
  for fn in (tlinalg.solve_pd, tpd.solve_pd):  # plain, and the CPU dispatch
    got = fn(torch.as_tensor(H), torch.as_tensor(g)).numpy()
    # same column Cholesky in float64: agreement to roundoff
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@functools.cache
def _newton_jax(iters, polish):
  """The JAX plain Newton solve, vmapped and compiled once; grad_th is a
  traced argument so both thresholds share the compile."""
  ldof = np.asarray(LDOF, np.int32)
  return jax.jit(jax.vmap(
      lambda th, *a: jsolver._newton_jax(*a, iters, polish, ldof, 0,
                                         grad_th=th),
      in_axes=(None,) + (0,) * len(ARG_KEYS)))


@pytest.mark.parametrize('seed', [0, 3])
def test_newton_plain_matches_newton_jax(seed):
  args = random_newton_problem(16, 9, 12, 4, seed=seed)
  iters, polish = 12, 3
  for grad_th in (0.0, 1e-5):
    want = _newton_jax(iters, polish)(grad_th, *_jax_args(args))
    got = tsolver.newton_plain(*_torch_args(args), iters, polish, LDOF,
                               grad_th)
    # float64, the same algorithm: agreement to roundoff
    _assert_scaled([t.numpy() for t in got], want, 1e-10)


def test_newton_plain_matches_pallas_interpret_with_early_exit():
  args = random_newton_problem(128, 9, 12, 4, seed=1)
  iters, polish, th = 6, 3, 1e-5
  want = newton_solve_tpu(*[jnp.asarray(a) for a in args],
                          iterations=iters, ls_polish=polish, ldof=LDOF,
                          interpret=True, grad_th=th)
  early = tsolver.newton_plain(*_torch_args(args), iters, polish, LDOF, th)
  # float64 on both sides; the kernel brackets the linesearch in another
  # order of the same comparisons
  _assert_scaled([t.numpy() for t in early], want, 1e-9)
  # frozen envs stop at the tolerance: the early exit returns the
  # minimizer of the full fixed-iteration run to within it
  full = tsolver.newton_plain(*_torch_args(args), iters, polish, LDOF, 0.0)
  _assert_scaled([t.numpy() for t in early], [t.numpy() for t in full],
                 1e-4)


def _post_substep_qvel(fx, unsafe: bool) -> np.ndarray:
  """The captured Newton solve in float32, finished as the implicitfast
  substep does; per-env max |qvel|."""
  tsolver.UNSAFE_LS_POLISH = unsafe
  try:
    ldof = tuple(int(i) for i in fx['ldof'])
    args = [torch.as_tensor(np.array(fx[k])) for k in ARG_KEYS]
    _, ff, fl, fc = tsolver.newton_plain(
        *args, int(fx['iterations']), int(fx['ls_polish']), ldof,
        float(fx['grad_th']))
    qfrc = ff + torch.einsum('bcv,bc->bv', args[3], fc)
    qfrc = qfrc.index_add(1, torch.as_tensor(ldof), args[7].float() * fl)
    dt = float(fx['dt'])
    A = args[0] + dt * torch.diag_embed(torch.as_tensor(fx['deriv']))
    qacc = tlinalg.solve_pd(A, torch.as_tensor(fx['qfrc_smooth']) + qfrc)
    qvel = torch.as_tensor(fx['qvel']) + dt * qacc
    return np.nan_to_num(qvel.abs().numpy(), nan=np.inf).max(-1)
  finally:
    tsolver.UNSAFE_LS_POLISH = False


@pytest.fixture(scope='module')
def fx():
  return np.load(FIXTURE)


def test_safeguarded_polish_contains_captured_blowup(fx):
  limit = float(fx['qvel_limit'])
  peaks = _post_substep_qvel(fx, unsafe=False)
  assert np.all(np.isfinite(peaks))
  assert peaks.max() < 0.2 * limit, peaks


def test_unguarded_polish_still_bites(fx):
  limit = float(fx['qvel_limit'])
  peaks = _post_substep_qvel(fx, unsafe=True)
  assert peaks[0] > limit, peaks
  assert peaks[1] < 0.2 * limit, peaks


# ---- what the K2 kernel relies on (csrc/newton.cu) -------------------------

CONTACT = (3, 4, 5, 6)  # cJ, c_aref, cD, c_act in the argument list


@pytest.fixture(scope='module')
def g1_newton():
  return g1_newton_problem(4, seed=0)


def _contact_rows(args, rows):
  out = list(args)
  for i in CONTACT:
    out[i] = args[i][:, rows].contiguous()
  return out


@pytest.mark.parametrize('case', ['delete_inactive', 'permute'])
def test_newton_plain_ignores_inactive_rows_and_row_order(g1_newton, case):
  """The kernel loads only the active contact rows, packed: deleting the
  rows with c_act == False, or reordering the rows, changes no output
  (float64; the sums only lose exact zeros or change order)."""
  args, iters, polish, ldof, th = g1_newton
  want = tsolver.newton_plain(*args, iters, polish, ldof, th)
  ncr = args[3].shape[1]
  if case == 'permute':
    rows = torch.as_tensor(np.random.default_rng(0).permutation(ncr))
    got = tsolver.newton_plain(*_contact_rows(args, rows), iters, polish,
                               ldof, th)
    _assert_scaled([t.numpy() for t in got[:3]] + [got[3].numpy()],
                   [t.numpy() for t in want[:3]] + [want[3][:, rows].numpy()],
                   1e-12)
    return
  assert not bool(args[6].all()), 'the input has no inactive contact row'
  for b in range(args[0].shape[0]):  # each env drops its own rows
    one = [t[b:b + 1] for t in args]
    rows = torch.nonzero(one[6][0])[:, 0]
    got = tsolver.newton_plain(*_contact_rows(one, rows), iters, polish,
                               ldof, th)
    assert not bool(want[3][b][~one[6][0]].any())  # inactive rows: no force
    _assert_scaled([t.numpy() for t in got[:3]] + [got[3].numpy()],
                   [t[b:b + 1].numpy() for t in want[:3]]
                   + [want[3][b:b + 1, rows].numpy()], 1e-12)


@pytest.mark.parametrize('k', [0, 1, 3, 6])
def test_newton_plain_frozen_envs_ignore_the_iteration_cap(g1_newton, k):
  """The kernel leaves its loop once ||grad||^2 <= grad_th^2: on every env
  whose gradient is under the threshold after k iterations, k and k + 20
  iterations give the same result. Env 0 has no active contact row, env 1
  is warm-started at its solution, envs 2 and 3 are as they come."""
  args, iters, polish, ldof, th = g1_newton
  args = [t.clone() for t in args]
  args[6][0] = False
  args[5][0] = 0.0
  solved = tsolver.newton_plain(*args, 40, polish, ldof, th)[0]
  args[2][1] = solved[1]
  x, ff, fl, fc = short = tsolver.newton_plain(*args, k, polish, ldof, th)
  jt = (ff + torch.einsum('bcv,bc->bv', args[3], fc)).index_add(
      1, torch.as_tensor(ldof), args[7] * fl)
  grad = torch.einsum('bij,bj->bi', args[0], x - args[1]) - jt
  frozen = (grad * grad).sum(-1) <= th * th
  assert bool(frozen[1]), 'the env warm-started at its solution moves'
  assert k < 6 or bool(frozen[0]), 'the contact-free env has not converged'
  assert not bool(frozen.all()) or k >= 6
  full = tsolver.newton_plain(*args, k + 20, polish, ldof, th)
  for name, a, b in zip(('qacc', 'ff', 'fl', 'fc'), short, full):
    np.testing.assert_allclose(a[frozen].numpy(), b[frozen].numpy(), rtol=0,
                               atol=1e-12, err_msg=name)
