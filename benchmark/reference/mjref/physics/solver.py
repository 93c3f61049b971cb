"""Newton constraint solver (primal, acceleration space), batched.

Counterpart of mjlab_tpu/physics/solver.py. Per env it minimizes over qacc
    C(x) = 0.5 (x - a_smooth)^T M (x - a_smooth) + sum_i s_i(J_i x - aref_i)
with one-sided quadratic costs for limits/contacts (the pyramidal cone)
and Huber costs for dof friction loss: exact Hessian, dense Cholesky
(ops/pd_solve.py, plain torch), and a parallel exact linesearch on the
convex phi(alpha).

`newton_plain` is the plain version of the port's kernel K2, in plain
torch on any device; `solve` runs it. The elliptic cone and equality rows
are not copied (constraint.make_efc refuses such models).
"""

from __future__ import annotations

import numpy as np
import torch

from mjref.ops import pd_solve as _pd_solve
from mjref.physics import constraint as _constraint
from mjref.physics.tables import ix as _ix
from mjref.physics.tables import table
from mjref.physics.types import Data, Model

_EPS = 1e-15
_SCALES = (0.0, 0.125, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 4.0, 8.0)


def _forces_oneside(jar, D, active):
  """Forces of one-sided rows."""
  quad = (jar < 0) & active
  return torch.where(quad, -D * jar, torch.zeros_like(jar)), quad


def _forces_friction(jar, D, floss, active):
  act = active & (floss > 0)
  f = torch.where(act, -torch.minimum(torch.maximum(D * jar, -floss), floss),
                  torch.zeros_like(jar))
  quad = act & ((D * jar).abs() < floss)
  return f, quad


def _cost_oneside(jar, D, active):
  quad = (jar < 0) & active
  return torch.where(quad, 0.5 * D * jar * jar,
                     torch.zeros_like(jar)).sum(-1)


def _cost_friction(jar, D, floss, active):
  act = active & (floss > 0)
  quad = 0.5 * D * jar * jar
  lin = floss * jar.abs() - 0.5 * floss * floss / D.clamp_min(_EPS)
  s = torch.where((D * jar).abs() < floss, quad, lin)
  return torch.where(act, s, torch.zeros_like(s)).sum(-1)


def newton_plain(M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD,
                 l_act, f_aref, fD, floss, f_act, iterations: int,
                 ls_polish: int, ldof, grad_th: float):
  """Batched structured Newton solve -> (qacc (B,n), f_friction (B,n),
  f_limit (B,nl), f_contact (B,nc)). Activity masks are bool."""
  return _newton_plain(M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref,
                       lD, l_act, f_aref, fD, floss, f_act, iterations,
                       ls_polish, ldof, grad_th)[0]


def _newton_plain(M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD,
                  l_act, f_aref, fD, floss, f_act, iterations, ls_polish,
                  ldof, grad_th):
  """(newton_plain's result, (B,) the iterations each env stepped before
  the freeze rule stopped it)."""
  ldof_ix = _ix(ldof, M.device)
  c_act, l_act, f_act = c_act.bool(), l_act.bool(), f_act.bool()
  mv = lambda A, v: torch.einsum('...ij,...j->...i', A, v)

  def jars_of(x):
    return (x - f_aref, l_sign * x[:, ldof_ix] - l_aref, mv(cJ, x) - c_aref)

  def forces_of(jars):
    jf, jl, jc = jars
    ff, qf = _forces_friction(jf, fD, floss, f_act)
    fl, ql = _forces_oneside(jl, lD, l_act)
    fc, qc = _forces_oneside(jc, cD, c_act)
    return (ff, fl, fc), (qf, ql, qc)

  def cost_of(x):
    jf, jl, jc = jars_of(x)
    dx = x - a0
    return (0.5 * (dx * mv(M, dx)).sum(-1)
            + _cost_friction(jf, fD, floss, f_act)
            + _cost_oneside(jl, lD, l_act)
            + _cost_oneside(jc, cD, c_act))

  x = torch.where((cost_of(ws) < cost_of(a0))[:, None], ws, a0)
  scales = table(np.asarray(_SCALES), M.dtype, M.device)
  eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
  zero = M.new_zeros(())
  need = torch.zeros(M.shape[0], dtype=torch.long, device=M.device)

  for _ in range(iterations):
    jars = jars_of(x)
    jf0, jl0, jc0 = jars
    forces, (qf, ql, qc) = forces_of(jars)
    grad = mv(M, x - a0) - constraint_force(cJ, l_sign, ldof, forces)
    # converged envs freeze (MuJoCo mj_solNewton termination)
    live = (grad * grad).sum(-1) > grad_th * grad_th
    need += live.long()

    # Hessian: M + diagonal (friction + limit) + dense contact part
    diag = torch.zeros_like(x).index_add(1, ldof_ix,
                                         torch.where(ql, lD, zero))
    diag = diag + torch.where(qf, fD, zero)
    Dq_c = torch.where(qc, cD, zero)
    H = M + (cJ.transpose(-1, -2) * Dq_c[:, None, :]) @ cJ
    H = H + torch.diag_embed(diag) + 1e-12 * eye
    dx = _pd_solve.solve_pd(H, -grad)

    # parallel linesearch on the convex piecewise-quadratic phi
    jd_f = dx
    jd_l = l_sign * dx[:, ldof_ix]
    jd_c = mv(cJ, dx)
    Md = mv(M, dx)
    dMd = (dx * Md).sum(-1)
    xMd = ((x - a0) * Md).sum(-1)

    def phi_grad_hess(alpha):  # alpha (B, S) -> g, h (B, S)
      a = alpha[..., None]  # per-env row data broadcasts over alpha
      ff_a, qf_a = _forces_friction(jf0[:, None] + a * jd_f[:, None],
                                    fD[:, None], floss[:, None],
                                    f_act[:, None])
      fl_a, ql_a = _forces_oneside(jl0[:, None] + a * jd_l[:, None],
                                   lD[:, None], l_act[:, None])
      fc_a, qc_a = _forces_oneside(jc0[:, None] + a * jd_c[:, None],
                                   cD[:, None], c_act[:, None])
      g = (alpha * dMd[:, None] + xMd[:, None]
           - (ff_a * jd_f[:, None]).sum(-1) - (fl_a * jd_l[:, None]).sum(-1)
           - (fc_a * jd_c[:, None]).sum(-1))
      h = (dMd[:, None]
           + (torch.where(qf_a, fD[:, None], zero) * (jd_f * jd_f)[:, None]
              ).sum(-1)
           + (torch.where(ql_a, lD[:, None], zero) * (jd_l * jd_l)[:, None]
              ).sum(-1)
           + (torch.where(qc_a, cD[:, None], zero) * (jd_c * jd_c)[:, None]
              ).sum(-1))
      return g, h

    g0, h0 = phi_grad_hess(torch.zeros_like(dMd)[:, None])
    a1 = (-g0[:, 0] / h0[:, 0].clamp_min(_EPS)).clamp_min(0.0)
    grid = a1[:, None] * scales
    gg, _ = phi_grad_hess(grid)
    neg = gg <= 0.0
    lo_idx = torch.argmax(torch.where(neg, scales, -1.0), dim=-1,
                          keepdim=True)
    lo = torch.gather(grid, 1, lo_idx)[:, 0]
    g_lo = torch.gather(gg, 1, lo_idx)[:, 0]
    pos = gg > 0.0
    hi_idx = torch.argmin(torch.where(pos, scales, float('inf')), dim=-1,
                          keepdim=True)
    any_pos = pos.any(-1)
    hi = torch.where(any_pos, torch.gather(grid, 1, hi_idx)[:, 0],
                     grid[:, -1])
    g_hi = torch.where(any_pos, torch.gather(gg, 1, hi_idx)[:, 0],
                       gg[:, -1])
    denom = g_hi - g_lo
    big = denom.abs() > _EPS
    alpha = torch.where(
        big, lo - g_lo * (hi - lo) / torch.where(big, denom,
                                                 torch.ones_like(denom)), lo)
    alpha = torch.where(any_pos, alpha, grid[:, -1])

    # safeguarded polish: phi' is nondecreasing, so keep the [lo, hi]
    # bracket and bisect whenever the 1D Newton step leaves it
    found = any_pos
    for _p in range(ls_polish):
      g, h = phi_grad_hess(alpha[:, None])
      g, h = g[:, 0], h[:, 0]
      negp = g <= 0
      lo = torch.where(negp, torch.maximum(alpha, lo), lo)
      hi = torch.where(negp, hi, torch.where(found, torch.minimum(alpha, hi),
                                             alpha))
      found = found | ~negp
      a_n = alpha - g / h.clamp_min(_EPS)
      inside = (a_n >= lo) & (a_n <= hi)
      alpha = torch.where(found & ~inside, 0.5 * (lo + hi),
                          torch.maximum(a_n, lo))
    alpha = torch.where(live, alpha.clamp_min(0.0), zero)
    x = x + alpha[:, None] * dx

  forces, _ = forces_of(jars_of(x))
  return (x,) + forces, need


def solver_params(stat):
  """(iterations, ls_polish, ldof, grad_th) of a model, as the JAX engine
  derives them: ls_iterations buys 1D polish steps beyond the 10-point
  grid; grad_th is MuJoCo's tolerance * meaninertia * max(1, nv)."""
  ldof = tuple(int(i) for i in _constraint.limit_dofadr(stat))
  ls_polish = max(1, min((int(stat.ls_iterations) - 10) // 4, 6))
  grad_th = (float(stat.newton_tolerance) * float(stat.meaninertia)
             * max(1, stat.nv))
  return int(stat.iterations), ls_polish, ldof, grad_th


def newton_steps(args: tuple, iterations: int, ls_polish: int,
                 ldof: tuple, grad_th: float) -> torch.Tensor:
  """(B,) the Newton iterations each env steps before the freeze rule
  (||grad||^2 <= grad_th^2) stops it, counted on the plain solver: the
  gradient after k plain iterations decides iteration k + 1. `args` are
  newton_args'."""
  return _newton_plain(*args, iterations, ls_polish, ldof, grad_th)[1]


def constraint_force(cJ, l_sign, ldof: tuple, forces):
  """J^T f (B, n): the row forces (ff, fl, fc) mapped to joint space by
  the structured blocks (the dense contact rows cJ, the limit signs at the
  dofs `ldof`)."""
  ff, fl, fc = forces
  return (ff + torch.einsum('bcv,bc->bv', cJ, fc)).index_add(
      1, _ix(ldof, cJ.device), l_sign * fl)


def newton_args(d: Data, efc: dict) -> tuple:
  """The tensor arguments of `newton_plain` (M through f_act), which are
  also those of the port's kernel wrapper, from a Data and `make_efc`'s
  rows."""
  return (d.qM, d.qacc_smooth, d.qacc_warmstart, efc['c_J'], efc['c_aref'],
          efc['c_D'], efc['c_active'], efc['l_sign'], efc['l_aref'],
          efc['l_D'], efc['l_active'], efc['f_aref'], efc['f_D'],
          efc['f_floss'], efc['f_active'])


def solve(m: Model, d: Data, efc: dict) -> Data:
  """Run the Newton solver; returns Data with qacc, qfrc_constraint and
  efc_force (MuJoCo's row order [friction | joint limits | contacts])."""
  s = m.stat
  lay = _constraint.efc_layout(s)
  iterations, ls_polish, ldof, grad_th = solver_params(s)
  args = newton_args(d, efc)
  x, *forces = newton_plain(*args, iterations, ls_polish, ldof, grad_th)
  ff, fl, fc = forces
  qfrc = constraint_force(args[3], efc['l_sign'], ldof, forces)
  efc_force = torch.cat([ff, fl[:, :lay.nl], fc[:, :lay.ncr]], dim=1)
  return d.replace(
      qacc=x, qfrc_constraint=qfrc, efc_force=efc_force,
      solver_niter=torch.full_like(d.solver_niter, iterations))
