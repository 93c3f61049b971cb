"""The frozen work functions against counts worked out by hand."""

import pytest
import torch

from benchmark.lib import work


def test_k1_by_hand():
  # column Cholesky of n = 2: column 0 takes 2 (sqrt, scale) + 1 (the
  # update of the one entry below), column 1 takes 4; two triangular
  # solves take 2 n^2 = 8: 15 FLOPs a system
  nbytes, flops = work.k1_call(batch=3, n=2)
  assert flops == 3 * 15
  assert nbytes == 4 * 3 * (4 + 2 * 2)  # H, g read and x written, float32


def test_mlp_by_hand():
  # (3 -> 2 -> 1): 2*3*2 + 2 and 2*2*1 + 1 FLOPs a row
  assert work.mlp_flops([(3, 2), (2, 1)], rows=5) == 5 * (14 + 5)


def test_least_time_takes_the_larger_bound():
  p = work.DEFAULT_PEAK
  assert work.least_s(p['hbm_bytes'], 0) == pytest.approx(1.0)
  assert work.least_s(0, p['f32_flops'] * 2) == pytest.approx(2.0)
  assert work.least_s(p['hbm_bytes'], p['f32_flops'] * 3) == \
      pytest.approx(3.0)


def test_k3_on_the_g1_by_hand():
  """The G1: 31 bodies, 69 geoms, 6 sites, 35 dofs; qM's lower-triangle
  pairs by the tree: the free joint's 6 dofs 21, each leg's 6 hinges
  sum(6 + k, k=1..6) = 57, the waist's 3 hinges 24, each arm's 7 hinges
  below the waist sum(9 + k, k=1..7) = 91: 21 + 2*57 + 24 + 2*91 = 341."""
  from mjlab_torch.tasks import registry
  env = registry.make('Mjlab-Velocity-Flat-Unitree-G1', device='cpu',
                      **{'scene.num_envs': 2})
  m = env.model
  B = 2
  qpos = torch.zeros(B, 36)
  qvel = torch.zeros(B, 35)
  outs = {'a': torch.zeros(B, 10), 'b': torch.zeros(B, 5)}
  nbytes, flops = work.k3_call(m, qpos, qvel, outs)
  assert flops == B * (572 * 31 + 108 * (69 + 6) + 150 * 35 + 12 * 341)
  # qpos, qvel and the outputs once, no per-env table (shared constants)
  assert nbytes == 4 * (B * 36 + B * 35 + B * 15)


def _newton_args(B, n, ncr, nl):
  f = lambda *s: torch.zeros(B, *s)
  b = lambda *s: torch.zeros(B, *s, dtype=torch.bool)
  M = torch.eye(n).expand(B, n, n).clone()
  return (M, f(n), f(n), f(ncr, n), f(ncr), f(ncr), b(ncr), f(nl), f(nl),
          f(nl), b(nl), f(n), f(n), f(n), b(n))


def test_k2_converged_at_the_start_by_hand():
  """M = I, a0 = ws = 0, no active row: the warm start is the optimum, so
  the solve takes no Newton step. What is left: the two warm-start costs
  (2 n^2 each, no rows), the final forces (no rows) and the gradient that
  finds convergence (2 n^2): 6 n^2 = 24 FLOPs at n = 2. Bytes: M, a0, ws,
  cJ, the row vectors and the outputs once: n^2 + ncr n + 3 ncr + 6 n +
  2 n + ncr floats an env at nl = 0."""
  B, n, ncr = 3, 2, 1
  args = _newton_args(B, n, ncr, 0)
  kw = {'iterations': 10, 'ls_polish': 1, 'ldof': (), 'grad_th': 1e-8}
  nbytes, flops = work.k2_call(args, kw)
  assert flops == B * 6 * n * n
  assert nbytes == 4 * B * (n * n + ncr * n + 3 * ncr + 6 * n + 2 * n + ncr)
