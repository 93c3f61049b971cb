"""K4's dispatch and static tables on the CPU (the kernel itself runs on the
card only: tests/test_torch_kernels.py holds it against its plain version
there).

`make_efc` builds the compacted pools' rows with K4 only for a float32 CUDA
batch of a pyramidal model that compacts and whose shapes the kernel takes;
everywhere else, on the CPU, for an elliptic model and for a model without
compaction (the Go1 flat scene), the plain version runs and the kernel's
wrapper is never called. The pool tables handed to the kernel hold each
pool's static data, frictional pool first, in the order the plain version
reads it; the same rows built from them, per slot and dof as the kernel
builds them, equal the plain version's."""

import types

import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import g1_flat_arrays, go1_flat_arrays
from mjlab_torch.physics import constraint, pipeline
from mjlab_torch.tasks import registry
from mjlab_torch.utils import tracing
from torch_parity import G1_FLAT_TASK


def _elliptic_arrays():
  cfg = registry.load_cfg(G1_FLAT_TASK).sim.mujoco
  cfg.cone = 'elliptic'
  return cfg.apply(g1_flat_arrays())


MODELS = {'g1_flat': g1_flat_arrays, 'g1_elliptic': _elliptic_arrays,
          'go1_flat': go1_flat_arrays}


def _states(arrays, m, n, seed):
  """n envs near the keyframe, root lowered 3 cm, with contacts (float64
  on the CPU)."""
  gen = torch.Generator().manual_seed(seed)
  qpos = torch.as_tensor(arrays.key_qpos[0]).expand(n, -1).clone()
  qpos[:, 7:] += 0.05 * torch.randn(n, m.stat.nq - 7, generator=gen,
                                    dtype=qpos.dtype)
  qpos[:, 2] -= 0.03
  qvel = 0.5 * torch.randn(n, m.stat.nv, generator=gen, dtype=qpos.dtype)
  d = tphys.make_batched_data(m, n, device='cpu').replace(qpos=qpos,
                                                          qvel=qvel)
  return pipeline.fwd_position(m, d)


@pytest.fixture(scope='module', params=sorted(MODELS))
def model(request):
  arrays = MODELS[request.param]()
  m = tphys.put_model(arrays, device='cpu', dtype=torch.float64)
  return request.param, m, _states(arrays, m, 3, 1)


def test_the_cpu_takes_the_plain_rows(model, monkeypatch):
  name, m, d = model
  tracing.reset_counters()
  called = []

  def refuse(*a, **k):
    raise AssertionError('the kernel wrapper was called on the CPU')

  monkeypatch.setattr(constraint._contact_rows, 'contact_rows_cuda', refuse)
  for fn in ('contacts_compacted_plain', '_contacts_all'):
    orig = getattr(constraint, fn)

    def spy(*a, _orig=orig, _fn=fn):
      called.append(_fn)
      return _orig(*a)

    monkeypatch.setattr(constraint, fn, spy)
  assert not constraint.contact_rows_takes(m, d)
  efc = constraint.make_efc(m, d)
  want = '_contacts_all' if name == 'go1_flat' else 'contacts_compacted_plain'
  assert called == [want]
  assert efc['c_J'].shape[-1] == m.stat.nv
  with torch.profiler.profile():
    constraint.make_efc(m, d)
  assert tracing.counters()['contact_rows_kernel'] == (0.0, 1, 1)


def test_which_models_the_kernel_takes(model, monkeypatch):
  """Beside the device and dtype, the model-class rules: a pyramidal model
  that compacts, within the kernel's shared memory (its fit rule, asked
  of the library on the card, is replaced here)."""
  name, m, d = model
  fits = []
  monkeypatch.setattr(constraint._contact_rows, 'fits',
                      lambda *a: fits.append(a) or True)
  like = lambda dev, dtype: types.SimpleNamespace(qpos=types.SimpleNamespace(
      device=torch.device(dev), dtype=dtype))
  on_card = like('cuda', torch.float32)
  assert constraint.contact_rows_takes(m, on_card) == (name == 'g1_flat')
  assert not constraint.contact_rows_takes(m, like('cuda', torch.float64))
  assert not constraint.contact_rows_takes(m, like('cpu', torch.float32))
  if name == 'g1_flat':
    s = m.stat
    assert fits == [(s.nv, s.ncon_cap, s.ncon_cap1, 2)]
    monkeypatch.setattr(constraint._contact_rows, 'fits', lambda *a: False)
    assert not constraint.contact_rows_takes(m, on_card)


def test_pool_tables_hold_the_plain_pools_static_data():
  m = tphys.put_model(g1_flat_arrays(), device='cpu')
  s = m.stat
  tab, dim, ancd, np3 = constraint._pool_tables(s)
  sl3, sl1 = constraint.compaction_slot_pools(s)
  assert np3 == len(sl3) and tab.shape == (len(sl3) + len(sl1), 5)
  assert tab.dtype == dim.dtype == np.int32 and ancd.dtype == np.int8
  assert ancd.shape == (len(tab), s.nv)
  for lo, slots in ((0, sl3), (np3, sl1)):
    anc, b1, b2, r1, r2 = constraint._pool_static(
        s, tuple(int(x) for x in slots))
    part = slice(lo, lo + len(slots))
    np.testing.assert_array_equal(tab[part, 0], slots)
    for i, x in enumerate((b1, b2, r1, r2), start=1):
      np.testing.assert_array_equal(tab[part, i], x)
    np.testing.assert_array_equal(ancd[part], anc)
    np.testing.assert_array_equal(dim[part], s.con_dim[slots])
  assert set(np.unique(ancd)) <= {-1, 0, 1}


def _rows_from_tables(m, d):
  """The c block as K4 builds it, per selected slot and dof from the pool
  tables and the selected pool positions, written in torch."""
  s = m.stat
  con = d.contact
  tab, dim, ancd, np3 = (torch.as_tensor(x) if isinstance(x, np.ndarray)
                         else x for x in constraint._pool_tables(s))
  tab, dim = tab.long(), dim.long()
  A = constraint._pyramid_axes(s)
  pdist = con.dist - con.includemargin
  sl3, sl1 = constraint.compaction_slot_pools(s)
  q = torch.cat([
      constraint.deepest(pdist[:, torch.as_tensor(sl3).long()], s.ncon_cap),
      np3 + constraint.deepest(pdist[:, torch.as_tensor(sl1).long()],
                               s.ncon_cap1)], 1)  # (B, K) pool positions
  B, K = q.shape
  K3 = s.ncon_cap
  t = tab[q]  # (B, K, 5)
  at = lambda x: torch.gather(x, 1, t[..., 0].reshape(B, K, *(
      1,) * (x.dim() - 2)).expand(B, K, *x.shape[2:]))
  com = lambda r: torch.gather(d.subtree_com, 1,
                               r[..., None].expand(B, K, 3))
  p, pos, frame, fr = at(pdist), at(con.pos), at(con.frame), at(con.friction)
  ad = ancd[q].to(p.dtype)  # (B, K, nv)
  rel = torch.where((ad > 0)[..., None], (pos - com(t[..., 4]))[:, :, None],
                    (pos - com(t[..., 3]))[:, :, None])
  ang, lin = d.cdof[:, None, :, :3], d.cdof[:, None, :, 3:]
  jt = (lin + torch.linalg.cross(ang.expand_as(rel), rel)) * ad[..., None]
  jr = ang * ad[..., None]
  tf = torch.einsum('bkfx,bkvx->bkfv', frame, jt)
  rf = torch.einsum('bkfx,bkvx->bkfv', frame, jr)
  vt, vr = tf @ d.qvel[:, None, :, None], rf @ d.qvel[:, None, :, None]
  nd = dim[q] - 1
  mu = torch.where(torch.arange(A) < nd[..., None], fr[..., :A], 0.0)
  b, k, imp = constraint._kbi(at(con.solref), at(con.solimp), p,
                              m.opt.timestep, True)
  invw = m.body_invweight0[t[..., 1], 0] + m.body_invweight0[t[..., 2], 0]
  mu0 = fr[..., 0]
  w = torch.cat([(invw * (1 + mu0 * mu0) * 2.0 * mu0 * mu0
                  / m.opt.impratio)[:, :K3], invw[:, K3:]], 1)
  D = 1.0 / ((1.0 - imp) / imp * w).clamp_min(1e-15)
  axes = torch.cat([tf[:, :, 1:3], rf], 2)[:, :K3, :A]  # (B, K3, A, nv)
  vax = torch.cat([vt[:, :, 1:3, 0], vr[:, :, :, 0]], 2)[:, :K3, :A]
  sign = torch.tensor([1.0, -1.0], dtype=p.dtype)
  J3 = tf[:, :K3, None, None, 0] + sign[:, None] * (
      mu[:, :K3, :, None] * axes)[:, :, :, None]
  v3 = vt[:, :K3, None, None, 0, 0] + sign * (mu[:, :K3] * vax)[..., None]
  act3 = (torch.arange(A) < nd[:, :K3, None]) & (p[:, :K3, None] < 0)
  rows = lambda x3, x1: torch.cat([x3.reshape(B, -1), x1], 1)
  act = rows(act3[..., None].expand(B, K3, A, 2), p[:, K3:] < 0)
  return (torch.cat([J3.reshape(B, -1, s.nv), tf[:, K3:, 0]], 1),
          torch.where(act, rows(D[:, :K3, None, None].expand(B, K3, A, 2),
                                D[:, K3:]), 0.0),
          rows(-b[:, :K3, None, None] * v3
               - (k * imp * p)[:, :K3, None, None],
               -b[:, K3:] * vt[:, K3:, 0, 0] - (k * imp * p)[:, K3:]),
          act, rows(p[:, :K3, None, None].expand(B, K3, A, 2), p[:, K3:]))


def test_rows_from_the_tables_equal_the_plain_rows():
  arrays = g1_flat_arrays()
  m = tphys.put_model(arrays, device='cpu', dtype=torch.float64)
  d = _states(arrays, m, 4, 2)
  got = _rows_from_tables(m, d)
  want = list(constraint.contacts_compacted_plain(m, d, m.opt.timestep,
                                                  True)[0])
  want[1] = torch.where(want[3], want[1], 0.0)
  assert int(want[3].sum()) > 0
  assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
  for g, w in zip(got[:3], want[:3]):
    torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
