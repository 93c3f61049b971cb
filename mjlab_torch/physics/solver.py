"""Newton constraint solver (primal, acceleration space), batched.

Counterpart of mjlab_tpu/physics/solver.py. Per env it minimizes over qacc
    C(x) = 0.5 (x - a_smooth)^T M (x - a_smooth) + sum_i s_i(J_i x - aref_i)
with one-sided quadratic costs for limits/contacts, Huber costs for dof
friction loss and, on an elliptic model, MuJoCo's elliptic-cone cost of
each frictional contact (three zones: inside the cone no force, below it
a quadratic of every row, between them a cost of the distance to the cone
with a non-diagonal Hessian block): exact Hessian, dense Cholesky (K1,
ops/pd_solve.py, on the card), and a parallel exact linesearch on the
convex phi(alpha).

`newton_plain` is the plain version of kernel K2 (ops/newton.py). `solve`
dispatches: a batch on a CUDA device runs the kernel when the model fits
its shared-memory rule (ops.newton.fits), its cone is pyramidal and it has
no equality rows (K2 implements the pyramidal cost of one-sided rows
alone, as the JAX package's whole-solver kernel; tendon-limit rows ride
in its contact block), else the plain version; a batch on the CPU runs
the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.ops import newton as _newton
from mjlab_torch.ops import pd_solve as _pd_solve
from mjlab_torch.physics import constraint as _constraint
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.tables import table
from mjlab_torch.physics.types import Data, Model

_EPS = 1e-15
_SCALES = (0.0, 0.125, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 4.0, 8.0)

# Test-only: revert the linesearch polish to the unguarded 1D Newton step
# that overshoots at the kinks of stiff deep-penetration landscapes
# (tests/data/blowup_ls_fixture.npz). Read on every call.
UNSAFE_LS_POLISH = False


def _forces_oneside(jar, D, active, bilateral=None):
  """Forces of one-sided rows; a row of `bilateral` (an equality row) has
  its quadratic cost on both sides."""
  quad = (jar < 0) & active
  if bilateral is not None:
    quad = quad | (bilateral & active)
  return torch.where(quad, -D * jar, torch.zeros_like(jar)), quad


def _forces_friction(jar, D, floss, active):
  act = active & (floss > 0)
  f = torch.where(act, -torch.minimum(torch.maximum(D * jar, -floss), floss),
                  torch.zeros_like(jar))
  quad = act & ((D * jar).abs() < floss)
  return f, quad


def _cost_oneside(jar, D, active, bilateral=None):
  quad = (jar < 0) & active
  if bilateral is not None:
    quad = quad | (bilateral & active)
  return torch.where(quad, 0.5 * D * jar * jar,
                     torch.zeros_like(jar)).sum(-1)


def _cost_friction(jar, D, floss, active):
  act = active & (floss > 0)
  quad = 0.5 * D * jar * jar
  lin = floss * jar.abs() - 0.5 * floss * floss / D.clamp_min(_EPS)
  s = torch.where((D * jar).abs() < floss, quad, lin)
  return torch.where(act, s, torch.zeros_like(s)).sum(-1)


# ---------------------------------------------------------------------------
# elliptic-cone contact pieces: MuJoCo's zone formulas, the JAX engine's
# expressions (its _EPS clamps included); leading axes (..., NX)
# ---------------------------------------------------------------------------


def _elliptic_zones(jx, xD, mu, fr, act):
  """Common elliptic quantities of residuals jx (..., NX, DM): (mid, bot,
  K, z, w, Tu), the zone masks with the active gate folded in."""
  N = jx[..., 0]
  u = jx[..., 1:] * fr / mu.clamp_min(_EPS)[..., None]
  Tu = torch.sqrt((u * u).sum(-1).clamp_min(_EPS))
  top = N >= mu * Tu
  bottom = mu * N + Tu <= 0.0
  mid = act & ~top & ~bottom
  bot = act & bottom & ~top
  K = xD[..., 0] / (2.0 * (1.0 + mu * mu))
  z = mu * Tu - N
  w = (u / Tu[..., None]) * fr  # dC/djar_t direction scale
  return mid, bot, K, z, w, Tu


def _elliptic_forces(jx, xD, mu, fr, act, zones=None):
  """(forces (..., NX, DM), cost (...)) of the elliptic block; `zones`:
  _elliptic_zones' result when the caller has it."""
  mid, bot, K, z, w, _ = zones or _elliptic_zones(jx, xD, mu, fr, act)
  zero = jx.new_zeros(())
  f_mid = torch.cat([(2.0 * K * z)[..., None], -(2.0 * K * z)[..., None] * w],
                    -1)
  f_bot = -xD * jx
  f = torch.where(mid[..., None], f_mid,
                  torch.where(bot[..., None], f_bot, zero))
  cost = torch.where(mid, K * z * z,
                     torch.where(bot, 0.5 * (xD * jx * jx).sum(-1),
                                 zero)).sum(-1)
  return f, cost


def _elliptic_hess(jx, xD, mu, fr, act):
  """Exact per-contact cost Hessian blocks (..., NX, DM, DM)."""
  mid, bot, K, z, w, Tu = _elliptic_zones(jx, xD, mu, fr, act)
  dm = jx.shape[-1]
  zero = jx.new_zeros(())
  g = torch.cat([-torch.ones_like(w[..., :1]), w], -1)  # (..., DM)
  ggT = g[..., :, None] * g[..., None, :]
  # tangential curvature (diag(fr^2) - w w^T) / (mu Tu), zero row/col 0
  eye_t = torch.diag(torch.cat([jx.new_zeros(1), jx.new_ones(dm - 1)]))
  fr_full = torch.cat([torch.zeros_like(w[..., :1]), fr], -1)
  w_full = torch.cat([torch.zeros_like(w[..., :1]), w], -1)
  diag_fr2 = eye_t * (fr_full[..., :, None] * fr_full[..., None, :])
  wwT = w_full[..., :, None] * w_full[..., None, :]
  denom = (mu * Tu).clamp_min(_EPS)
  B_mid = 2.0 * K[..., None, None] * (
      ggT + (z / denom)[..., None, None] * (diag_fr2 - wwT))
  B_bot = torch.eye(dm, dtype=jx.dtype, device=jx.device) * xD[..., None, :]
  return torch.where(mid[..., None, None], B_mid,
                     torch.where(bot[..., None, None], B_bot, zero))


def _elliptic_gh(jx, jdx, xD, mu, fr, act):
  """The elliptic block's share of the linesearch's phi'(alpha) and
  phi''(alpha) at residuals jx along the direction jdx: (-sum f . jdx,
  sum jdx^T B jdx), summed over the last two axes."""
  zones = _elliptic_zones(jx, xD, mu, fr, act)
  mid, bot, K, z, w, Tu = zones
  zero = jx.new_zeros(())
  wj = (w * jdx[..., 1:]).sum(-1)
  gdot = -jdx[..., 0] + wj
  denom = (mu * Tu).clamp_min(_EPS)
  h_mid = 2.0 * K * (gdot * gdot
                     + (z / denom) * (((fr * jdx[..., 1:]) ** 2).sum(-1)
                                      - wj ** 2))
  h_bot = (xD * jdx * jdx).sum(-1)
  f, _ = _elliptic_forces(jx, xD, mu, fr, act, zones)
  g = -(f * jdx).sum((-2, -1))
  h = torch.where(mid, h_mid, torch.where(bot, h_bot, zero)).sum(-1)
  return g, h


def newton_plain(M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD,
                 l_act, f_aref, fD, floss, f_act, iterations: int,
                 ls_polish: int, ldof, grad_th: float, xargs=None,
                 ne: int = 0):
  """Batched structured Newton solve -> (qacc (B,n), f_friction (B,n),
  f_limit (B,nl), f_contact (B,nc)[, f_elliptic (B,NX,DM)]). Activity
  masks are bool. xargs = (xJ (B,NX,DM,n), x_aref, xD, x_mu, x_fr, x_act)
  adds the elliptic-cone block (`elliptic_args`). The first `ne` rows of
  the dense block are bilateral (equality rows): no one-sided clamp."""
  return _newton_plain(M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref,
                       lD, l_act, f_aref, fD, floss, f_act, iterations,
                       ls_polish, ldof, grad_th, xargs, ne)[0]


def _newton_plain(M, a0, ws, cJ, c_aref, cD, c_act, l_sign, l_aref, lD,
                  l_act, f_aref, fD, floss, f_act, iterations, ls_polish,
                  ldof, grad_th, xargs, ne):
  """(newton_plain's result, (B,) the iterations each env stepped before
  the freeze rule stopped it)."""
  ldof_ix = _ix(ldof, M.device)
  c_act, l_act, f_act = c_act.bool(), l_act.bool(), f_act.bool()
  bilat = (table(np.arange(cJ.shape[1]) < ne, torch.bool, M.device)
           if ne else None)
  mv = lambda A, v: torch.einsum('...ij,...j->...i', A, v)
  elliptic = xargs is not None
  if elliptic:
    xJ, x_aref, xD, x_mu, x_fr, x_act = xargs
    x_act = x_act.bool()
    x_s = (xD[:, None], x_mu[:, None], x_fr[:, None], x_act[:, None])

  def jars_of(x):
    jars = (x - f_aref, l_sign * x[:, ldof_ix] - l_aref, mv(cJ, x) - c_aref)
    if elliptic:
      jars += (torch.einsum('bcdv,bv->bcd', xJ, x) - x_aref,)
    return jars

  def forces_of(jars):
    jf, jl, jc = jars[:3]
    ff, qf = _forces_friction(jf, fD, floss, f_act)
    fl, ql = _forces_oneside(jl, lD, l_act)
    fc, qc = _forces_oneside(jc, cD, c_act, bilat)
    forces = (ff, fl, fc)
    if elliptic:
      forces += (_elliptic_forces(jars[3], xD, x_mu, x_fr, x_act)[0],)
    return forces, (qf, ql, qc)

  def cost_of(x):
    jars = jars_of(x)
    jf, jl, jc = jars[:3]
    dx = x - a0
    cost = (0.5 * (dx * mv(M, dx)).sum(-1)
            + _cost_friction(jf, fD, floss, f_act)
            + _cost_oneside(jl, lD, l_act)
            + _cost_oneside(jc, cD, c_act, bilat))
    if elliptic:
      cost = cost + _elliptic_forces(jars[3], xD, x_mu, x_fr, x_act)[1]
    return cost

  x = torch.where((cost_of(ws) < cost_of(a0))[:, None], ws, a0)
  scales = table(np.asarray(_SCALES), M.dtype, M.device)
  eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
  zero = M.new_zeros(())
  need = torch.zeros(M.shape[0], dtype=torch.long, device=M.device)

  for _ in range(iterations):
    jars = jars_of(x)
    jf0, jl0, jc0 = jars[:3]
    forces, (qf, ql, qc) = forces_of(jars)
    grad = mv(M, x - a0) - constraint_force(cJ, l_sign, ldof, forces,
                                            xJ if elliptic else None)
    # converged envs freeze (MuJoCo mj_solNewton termination)
    live = (grad * grad).sum(-1) > grad_th * grad_th
    need += live.long()

    # Hessian: M + diagonal (friction + limit) + dense contact part
    # (+ the elliptic blocks J_c^T B_c J_c)
    diag = torch.zeros_like(x).index_add(1, ldof_ix,
                                         torch.where(ql, lD, zero))
    diag = diag + torch.where(qf, fD, zero)
    Dq_c = torch.where(qc, cD, zero)
    H = M + (cJ.transpose(-1, -2) * Dq_c[:, None, :]) @ cJ
    H = H + torch.diag_embed(diag) + 1e-12 * eye
    if elliptic:
      Bx = _elliptic_hess(jars[3], xD, x_mu, x_fr, x_act)
      H = H + (xJ.flatten(1, 2).transpose(-1, -2)
               @ (Bx @ xJ).flatten(1, 2))
    dx = _pd_solve.solve_pd(H, -grad)

    # parallel linesearch on the convex piecewise-quadratic phi
    jd_f = dx
    jd_l = l_sign * dx[:, ldof_ix]
    jd_c = mv(cJ, dx)
    if elliptic:
      jx0 = jars[3][:, None]  # per-env data broadcast over alpha
      jd_xs = torch.einsum('bcdv,bv->bcd', xJ, dx)[:, None]
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
                                   cD[:, None], c_act[:, None], bilat)
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
      if elliptic:
        gx, hx = _elliptic_gh(jx0 + alpha[..., None, None] * jd_xs,
                              jd_xs, *x_s)
        g = g + gx
        h = h + hx
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
      if UNSAFE_LS_POLISH:
        alpha = alpha - g / h.clamp_min(_EPS)
        continue
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
                 ldof: tuple, grad_th: float, xargs=None,
                 ne: int = 0) -> torch.Tensor:
  """(B,) the Newton iterations each env steps before the freeze rule
  (||grad||^2 <= grad_th^2) stops it, counted on the plain solver: the
  gradient after k plain iterations decides iteration k + 1. `args` are
  newton_args', `xargs` elliptic_args'."""
  return _newton_plain(*args, iterations, ls_polish, ldof, grad_th, xargs,
                       ne)[1]


def constraint_force(cJ, l_sign, ldof: tuple, forces, xJ=None):
  """J^T f (B, n): the row forces (ff, fl, fc[, fx]) mapped to joint space
  by the structured blocks (the dense contact rows cJ, the limit signs at
  the dofs `ldof`, the elliptic rows xJ)."""
  ff, fl, fc = forces[:3]
  out = (ff + torch.einsum('bcv,bc->bv', cJ, fc)).index_add(
      1, _ix(ldof, cJ.device), l_sign * fl)
  if xJ is not None:
    out = out + torch.einsum('bcdv,bcd->bv', xJ, forces[3])
  return out


def newton_args(d: Data, efc: dict) -> tuple:
  """The tensor arguments of `newton_plain` (M through f_act), which are
  also those of the kernel wrapper, from a Data and `make_efc`'s rows. The
  dense block is the contact rows with the equality rows (bilateral) and
  then the tendon-limit rows put in front, as the JAX engine's solve
  builds it."""
  pre = [k for k in ('e', 't') if f'{k}_J' in efc]

  def block(name, key):
    parts = [efc[f'{k}_{key}'] for k in pre] + [efc[f'c_{name}']]
    return torch.cat(parts, dim=1) if pre else parts[0]

  return (d.qM, d.qacc_smooth, d.qacc_warmstart, block('J', 'J'),
          block('aref', 'aref'), block('D', 'D'), block('active', 'active'),
          efc['l_sign'], efc['l_aref'], efc['l_D'], efc['l_active'],
          efc['f_aref'], efc['f_D'], efc['f_floss'], efc['f_active'])


def elliptic_args(efc: dict):
  """`newton_plain`'s xargs from `make_efc`'s rows: the x block of an
  elliptic model, else None."""
  if 'x_J' not in efc:
    return None
  return tuple(efc[k] for k in ('x_J', 'x_aref', 'x_D', 'x_mu', 'x_fr',
                                'x_active'))


def solve(m: Model, d: Data, efc: dict) -> Data:
  """Run the Newton solver; returns Data with qacc, qfrc_constraint and
  efc_force (MuJoCo's row order [equality | friction | joint limits |
  tendon limits | contacts]; on an elliptic model the frictionless and the
  elliptic rows go to their slots' rows)."""
  s = m.stat
  lay = _constraint.efc_layout(s)
  iterations, ls_polish, ldof, grad_th = solver_params(s)
  args = newton_args(d, efc)
  xargs = elliptic_args(efc)
  ne, nlt = lay.ne, lay.nlt
  ncr = args[3].shape[1]  # the dense block, equality and tendon rows in it
  # model-class gates, the JAX dispatch's: K2 solves the pyramidal cost of
  # one-sided rows (no equality rows) within its smem rule
  if (d.qpos.device.type != 'cpu' and xargs is None and ne == 0
      and _newton.fits(s.nv, ncr, len(ldof))):
    x, *forces = _newton.newton_solve_cuda(
        *args, iterations=iterations, ls_polish=ls_polish, ldof=ldof,
        grad_th=grad_th)
  else:
    x, *forces = newton_plain(*args, iterations, ls_polish, ldof, grad_th,
                              xargs, ne)
  ff, fl, fc = forces[:3]
  qfrc = constraint_force(args[3], efc['l_sign'], ldof, forces,
                          efc.get('x_J'))
  head = [fc[:, :ne], ff, fl[:, :lay.nl], fc[:, ne:ne + nlt]]
  fcon = fc[:, ne + nlt:]
  if xargs is None:
    efc_force = torch.cat(head + [fcon[:, :lay.ncr]], dim=1)
  else:
    # the dense rows [... | contacts by slot], one spare column past nefc
    # for the axes beyond a slot's condim, cut off after
    x_rows, c1_rows = _constraint.elliptic_row_maps(s)
    efc_force = torch.cat(head + [x.new_zeros((x.shape[0],
                                               lay.ncr + 1))], dim=1)
    if len(c1_rows):
      efc_force = efc_force.index_copy(1, _ix(c1_rows, x.device),
                                       fcon[:, :len(c1_rows)])
    fx = forces[3]
    if not _constraint.elliptic_block_empty(s):
      assert fx.shape[1] == x_rows.shape[0], (fx.shape, x_rows.shape)
      efc_force = efc_force.index_copy(1, _ix(x_rows.ravel(), x.device),
                                       fx.flatten(1))
    efc_force = efc_force[:, :lay.nefc]
  return d.replace(
      qacc=x, qfrc_constraint=qfrc, efc_force=efc_force,
      solver_niter=torch.full_like(d.solver_niter, iterations))
