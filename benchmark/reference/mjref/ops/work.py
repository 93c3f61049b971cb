"""The work of one call of each kernel, and the least time the card could
take for it.

Each `*_work` function returns (bytes, FLOPs) of one call from that call's
arguments and outputs: every input read once and every output written
once, and the arithmetic that these inputs need (where it depends on the
data, as K2's Newton steps do, what this call's data needs, not the most
it could). benchmark/lib/work.py turns them into the least time on the
card. K3's sizes (its per-env table, its qM pairs) are worked out from the
Model's own arrays, as csrc/smooth.cu lays them out.
"""

from __future__ import annotations

import numpy as np


def chol_solve_flops(n: int) -> int:
  """Column Cholesky plus forward and back substitution, per matrix."""
  chol = sum((2 * j + 2) + (n - 1 - j) * (2 * j + 1) for j in range(n))
  return chol + 2 * n * n


# K3's float-table segments, in csrc/smooth.cu's order: a segment goes
# into the per-env table, one row an env, when one of its Model fields
# carries a leading env axis (the scalar fields count as width 1)
_K3_SEGMENTS = (('body_pos', 'body_quat', 'body_ipos', 'body_iquat',
                 'body_inertia', 'body_mass'), ('jnt_pos', 'jnt_axis'),
                ('geom_pos', 'geom_quat'), ('site_pos', 'site_quat'),
                ('qpos0',), ('dof_armature',))
_K3_SCALARS = ('body_mass', 'qpos0', 'dof_armature')


def k3_per_env_floats(m) -> int:
  """Floats of K3's per-env table on Model `m` (0: the shared-table
  form)."""
  total = 0
  for seg in _K3_SEGMENTS:
    if seg[0] == 'site_pos' and not m.stat.nsite:
      continue
    parts = [getattr(m, f) for f in seg]
    parts = [t[..., None] if f in _K3_SCALARS else t
             for f, t in zip(seg, parts)]
    batch = [t.shape[0] for t in parts if t.dim() == 3]
    if batch:
      total += batch[0] * sum(t.shape[-2] * t.shape[-1] for t in parts)
  return total


def qm_pairs(s) -> int:
  """The (i, j <= i) entries of qM that K3 fills: j a dof of the body of
  dof i or of one of its ancestors."""
  anc = np.asarray(s.ancestor_mask) > 0.5
  return int(sum(anc[int(s.dof_bodyid[i]), :i + 1].sum()
                 for i in range(int(s.nv))))


def k3_work(m, qpos, qvel, outs: dict) -> 'tuple[int, int]':
  """K3: (bytes, FLOPs) of one call on the batch (qpos, qvel) of Model `m`
  with the outputs `outs` (the port's K3 wrapper's dict): qpos, qvel and the
  per-env table (the per-env form's) read once, every output written
  once."""
  s = m.stat
  out_floats = sum(v.numel() for v in outs.values())
  nbytes = qpos.element_size() * (
      qpos.numel() + qvel.numel() + out_floats + k3_per_env_floats(m))
  # arithmetic of csrc/smooth.cu per env: per body (kinematics, frames,
  # cinr, crb, RNE) ~572 FLOPs, per geom or site frame ~108, per dof (cdof,
  # cdof_dot, velocity, qM row product, bias) ~150, per qM entry 12
  flops = qpos.shape[0] * (572 * s.nbody + 108 * (s.ngeom + s.nsite)
                           + 150 * s.nv + 12 * qm_pairs(s))
  return nbytes, flops


def newton_work(args, iterations: int, ls_polish: int, ldof: tuple,
                grad_th: float):
  """K2 on the tensor arguments `args` (the port's K2 wrapper's, M through
  f_act): (Newton steps per env, active contact rows per env, active rows
  per env, bytes, FLOPs). Bytes: every input read and every output written
  once. FLOPs per step: residuals and gradient (cJ x, cJ^T f, M x), the
  lower-triangle Hessian (D cJ once, then 2 FLOPs per term and row),
  Cholesky and solves, the search direction (M dx, cJ dx), and 10 +
  ls_polish linesearch sums of ~8 FLOPs per row; plus the two warm-start
  costs, the gradient that finds convergence, and the final forces. Only
  active rows and only the steps before the freeze rule count, which the
  plain solver counts (one plain solve a call)."""
  from mjref.physics import solver
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
