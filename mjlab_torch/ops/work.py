"""The work of one call of each kernel, and the least time the card could
take for it.

Each `*_work` function returns (bytes, FLOPs) of one call from that call's
arguments and outputs: every input read once and every output written
once, and the arithmetic that these inputs need (where it depends on the
data, as K2's Newton steps do, what this call's data needs, not the most
it could). `bound_ms` turns them into the larger of the bytes over the
card's memory rate and the FLOPs over its float32 rate. `chip_smoke.py`
reports the kernels' bounds from these functions, and the kernel wrappers
charge them to an active op counter (utils/op_count.py).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def bound_ms(nbytes: float, flops: float):
  """(the least time in ms, 'bytes' or 'operations': which bounds it)."""
  t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
  t_ops = flops / F32_FLOPS_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def chol_solve_flops(n: int) -> int:
  """Column Cholesky plus forward and back substitution, per matrix."""
  chol = sum((2 * j + 2) + (n - 1 - j) * (2 * j + 1) for j in range(n))
  return chol + 2 * n * n


def pd_solve_work(H, g) -> 'tuple[int, int]':
  """K1: (bytes, FLOPs) of solving H x = g, H (B, n, n) and g (B, n): H
  and g read once, x written once, one factor and solve a matrix."""
  B, n = g.shape
  return (g.element_size() * B * (n * n + 2 * n), B * chol_solve_flops(n))


def k3_work(m, qpos, qvel, outs: dict) -> 'tuple[int, int]':
  """K3: (bytes, FLOPs) of one call on the batch (qpos, qvel) of Model `m`
  with the outputs `outs` (smooth_fused_cuda's dict): qpos, qvel and the
  per-env table (the per-env form's) read once, every output written
  once."""
  from mjlab_torch.ops import smooth_kernel as k_smooth
  s = m.stat
  out_floats = sum(v.numel() for v in outs.values())
  etab = k_smooth.plan_of(m).etab
  nbytes = qpos.element_size() * (
      qpos.numel() + qvel.numel() + out_floats
      + (0 if etab is None else etab.numel()))
  npairs = sum(len(p) for p in k_smooth.tree_of(s).qm_pairs)
  # arithmetic of csrc/smooth.cu per env: per body (kinematics, frames,
  # cinr, crb, RNE) ~572 FLOPs, per geom or site frame ~108, per dof (cdof,
  # cdof_dot, velocity, qM row product, bias) ~150, per qM entry 12
  flops = qpos.shape[0] * (572 * s.nbody + 108 * (s.ngeom + s.nsite)
                           + 150 * s.nv + 12 * npairs)
  return nbytes, flops


def newton_work(args, iterations: int, ls_polish: int, ldof: tuple,
                grad_th: float):
  """K2 on the tensor arguments `args` (newton_solve_cuda's, M through
  f_act): (Newton steps per env, active contact rows per env, active rows
  per env, bytes, FLOPs). Bytes: every input read and every output written
  once. FLOPs per step: residuals and gradient (cJ x, cJ^T f, M x), the
  lower-triangle Hessian (D cJ once, then 2 FLOPs per term and row),
  Cholesky and solves, the search direction (M dx, cJ dx), and 10 +
  ls_polish linesearch sums of ~8 FLOPs per row; plus the two warm-start
  costs, the gradient that finds convergence, and the final forces. Only
  active rows and only the steps before the freeze rule count, which the
  plain solver counts (one plain solve a call)."""
  from mjlab_torch.physics import solver
  B, n = args[1].shape
  ncr, nl = args[3].shape[1], len(ldof)
  nbytes = args[1].element_size() * B * (
      n * n + ncr * n + 3 * ncr + 4 * nl + 6 * n + 2 * n + nl + ncr)
  need = solver.newton_steps(args, iterations, ls_polish, ldof, grad_th)
  nc = args[6].sum(-1).long()
  rows = nc + args[10].sum(-1).long() + args[14].sum(-1).long()
  per_step = (6 * nc * n + 4 * n * n + n * (n + 1) * nc + nc * n
              + chol_solve_flops(n) + 8 * (10 + ls_polish) * rows)
  grad_flops = 2 * n * n + 4 * nc * n
  flops = int((need * per_step + (need < iterations) * grad_flops
               + 2 * (2 * n * n + 2 * nc * n) + 2 * nc * n).sum())
  return need, nc, rows, nbytes, flops


def contact_rows_work(B: int, nv: int, nbody: int, K3: int, K1: int, A: int,
                      npool: int) -> 'tuple[int, int]':
  """K4: (bytes, FLOPs) of building the c block of B envs from K3
  frictional slots (2 A rows each) and K1 frictionless ones (one row) of
  pools of npool entries in all. Bytes, float32: per env the selected
  slots' positions (int64) and contact data (dist - includemargin, pos,
  frame, friction, solref, solimp: 25 floats), cdof, subtree_com and qvel
  read once, c_J and c_D, c_aref, c_pos (floats) and c_active (bytes)
  written once; the static pool tables (5 + 1 int32 and nv bytes an entry)
  and body_invweight0 once. FLOPs per slot and dof: the translational
  column (15) and its rotation into the frame (15), the velocity sums (6),
  then per frictional row pair 3, with the rotational column (3), its
  rotation (15) and sums (6) where A > 2; per slot ~60 for the impedance
  and reference coefficients."""
  K, ncr = K3 + K1, 2 * A * K3 + K1
  per_env = (8 * K + 4 * 25 * K + 4 * (6 * nv + 3 * nbody + nv)
             + 4 * ncr * nv + 13 * ncr)
  static = npool * (24 + nv) + 4 * 2 * nbody
  per_slot_dof = 36 * K + (3 * A + (24 if A > 2 else 0)) * K3
  flops = B * (nv * per_slot_dof + 60 * K)
  return B * per_env + static, flops
