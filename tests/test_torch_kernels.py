"""The port's CUDA kernels against their plain versions on the card, at a
small batch of G1 flat envs. They need an NVIDIA GPU and the CUDA toolkit
and skip elsewhere; `python3 chip_smoke.py` holds the kernels at the main
path's full shapes."""

import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import g1_flat_arrays
from mjlab_torch.ops import newton as tnewton
from mjlab_torch.ops import pd_solve as tpd
from mjlab_torch.ops import smooth_kernel as tsk
from mjlab_torch.physics import constraint, linalg, pipeline, smooth
from mjlab_torch.physics import smooth_fused, solver

pytestmark = pytest.mark.cuda
B = 64
TOL = 1e-4  # float32 kernel vs float32 plain, relative to the field scale


@pytest.fixture(scope='module')
def g1():
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  m = tphys.put_model(g1_flat_arrays())
  gen = torch.Generator().manual_seed(0)
  d = tphys.make_batched_data(m, B)
  qpos = d.qpos.cpu()
  qpos[:, 7:] += 0.05 * torch.randn(B, m.stat.nq - 7, generator=gen)
  qpos[:, 2] -= 0.03
  d = d.replace(qpos=qpos.cuda(),
                qvel=(0.5 * torch.randn(B, m.stat.nv, generator=gen)).cuda())
  return m, d


def _rel(a, b):
  return float((a - b).abs().max() / (1 + b.abs().max()))


def test_smooth_kernel_matches_plain(g1):
  m, d = g1
  got = tsk.smooth_fused_cuda(m, d.qpos, d.qvel)
  want = smooth_fused.plain_all(m, d)
  for k in tsk.OUT_KEYS:
    assert _rel(got[k], getattr(want, k)) < TOL, k


def test_pd_solve_kernel_matches_plain(g1):
  m, d = g1
  d = smooth_fused.plain_all(m, d)
  g = torch.randn(B, m.stat.nv, device='cuda')
  assert _rel(tpd.solve_pd_cuda(d.qM, g), linalg.solve_pd(d.qM, g)) < TOL


def test_newton_kernel_matches_plain(g1):
  m, d = g1
  d = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  d = smooth.fwd_smooth(m, smooth.actuation(m, d))
  efc = constraint.make_efc(m, d)
  assert efc['c_active'].any()
  iters, polish, ldof, th = solver.solver_params(m.stat)
  args = (d.qM, d.qacc_smooth, d.qacc_warmstart, efc['c_J'], efc['c_aref'],
          efc['c_D'], efc['c_active'], efc['l_sign'], efc['l_aref'],
          efc['l_D'], efc['l_active'], efc['f_aref'], efc['f_D'],
          efc['f_floss'], efc['f_active'])
  got = tnewton.newton_solve_cuda(*args, iterations=iters, ls_polish=polish,
                                  ldof=ldof, grad_th=th)
  want = solver.newton_plain(*args, iters, polish, ldof, th)
  for g, w in zip(got, want):
    assert _rel(g, w) < 1e-3
