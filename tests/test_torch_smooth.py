"""Parity of the port's fused smooth stage (the plain version of kernel K3,
mjlab_torch/physics/smooth_fused.py:plain_all) with the JAX package: the
XLA stages it fuses (smooth_fused._xla_all) on the G1 flat model, and the
Pallas kernel itself in interpret mode (smooth_fused._fused_batched) on
TinyBot, whose small tree keeps interpret mode fast. States carry a
nonzero free-joint angular velocity, which exercises the joint-segment
rule of cdof_dot (mjlab_tpu/ops/smooth_kernel.py:385-392).

Also here, without a GPU: the schedule the CUDA kernel walks (`_Tree`: level
table, sweep order, qM bit mask), replayed in numpy against `plain_all`;
the once-per-model float table; and the model variants of the kernel's
edge-case gates (slide joints, gravity off) through both packages; the
per-env tables of a Model whose fields carry an env axis."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from chip_smoke import K3_SLIDE_JOINTS, g1_variant
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import smooth_fused as jsf
from mjlab_torch.asset_zoo import g1_flat_arrays
from mjlab_torch.ops import smooth_kernel as tsk
from mjlab_torch.physics import pipeline as tpipe
from mjlab_torch.physics import smooth_fused as tsf
from mjlab_torch.physics.io import ModelArrays
from mjlab_torch.sim.sim import expand_model_fields
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


# ---- the kernel's schedule and tables, on the CPU ---------------------------


def _mjmodel(name):
  return g1_flat_mjmodel() if name == 'g1' else tiny_bot_mjmodel()


@pytest.mark.parametrize('name', ['g1', 'tiny_bot'])
def test_level_table(name):
  stat = tphys.put_model(_mjmodel(name), device='cpu').stat
  tree = tsk.tree_of(stat)
  order = tree.table('order')
  ptr = tree.table('level_ptr')
  assert len(ptr) == tree.nlevel + 1 and ptr[0] == 0 and ptr[-1] == len(order)
  # every body once, the world body alone on the first level
  assert sorted(order) == list(range(stat.nbody))
  assert list(order[ptr[0]:ptr[1]]) == [0]
  level_of = {int(b): l for l in range(tree.nlevel)
              for b in order[ptr[l]:ptr[l + 1]]}
  parent = tree.table('parent')
  assert list(parent) == [int(p) for p in stat.body_parentid]
  assert tree.table('sweep').reshape(-1, 2).tolist() == [
      [int(b), int(parent[b])] for b in order]
  for b in range(1, stat.nbody):
    assert level_of[int(parent[b])] == level_of[b] - 1
  # read backwards, `order` visits every body before its parent: the
  # kernel's backward sweeps add each body into its parent in that order
  seen = set()
  for b in order[:0:-1]:
    seen.add(int(b))
    assert int(parent[b]) not in seen
  assert [len(l) for l in tree.levels] == [
      ptr[l + 1] - ptr[l] for l in range(1, tree.nlevel)]
  if name == 'g1':
    assert [len(l) for l in tree.levels] == [1, 3, 3, 3, 4, 4, 4, 2, 2, 2, 2]


def _walk_tables(tree, mass, xipos, cinr, cdof, armature):
  """The kernel's backward sweeps and its dense qM, replayed in numpy from
  the int table alone: subtree COM, and the mass matrix from the composite
  inertias (children added into parents along `order` reversed) and the
  bit mask."""
  sweep = tree.table('sweep').reshape(-1, 2)
  dof_body = tree.table('dof_body')
  mom = np.concatenate([mass[:, None] * xipos, mass[:, None]], -1)
  crb = cinr.copy()
  for b, p in sweep[:0:-1]:
    mom[p] += mom[b]
    if p != 0:
      crb[p] += crb[b]
  scom = mom[:, :3] / np.maximum(mom[:, 3:], 1e-12)
  nv = tree.nv
  words = (nv + 31) // 32
  mask = tree.table('qm_mask').view(np.uint32).reshape(nv, words)
  t = np.einsum('dij,dj->di', crb[dof_body], cdof)
  qM = np.zeros((nv, nv))
  for i in range(nv):
    for j in range(nv):
      r, c = max(i, j), min(i, j)
      if (mask[r, c >> 5] >> np.uint32(c & 31)) & np.uint32(1):
        qM[i, j] = t[r] @ cdof[c]
  return scom, qM + np.diag(armature), mask


def test_int_table_walk_reproduces_plain_g1():
  mj = g1_flat_mjmodel()
  _, _, tm, td = _setup(mj, g1_states)
  tree = tsk.tree_of(tm.stat)
  want = tsf.plain_all(tm, td)
  for b in range(td.qpos.shape[0]):
    scom, qM, mask = _walk_tables(
        tree, tm.body_mass.numpy(), want.xipos[b].numpy(),
        want.cinr[b].numpy(), want.cdof[b].numpy(), tm.dof_armature.numpy())
    np.testing.assert_allclose(scom, want.subtree_com[b].numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(qM, want.qM[b].numpy(), rtol=0, atol=TOL)
  # cvel without a sweep: the products of a body's ancestor dofs, root first
  aptr, aidx = tree.table('anc_ptr'), tree.table('anc_idx')
  cdof, qvel = want.cdof[0].numpy(), td.qvel[0].numpy()
  cvel = np.stack([sum((cdof[d] * qvel[d] for d in aidx[aptr[b]:aptr[b + 1]]),
                       np.zeros(6)) for b in range(tree.nbody)])
  np.testing.assert_allclose(cvel, want.cvel[0].numpy(), rtol=0, atol=TOL)
  # the bit mask is the lower triangle of qM's sparsity
  bits = sum(bin(int(w)).count('1') for w in mask.reshape(-1))
  assert bits == sum(len(p) for p in tree.qm_pairs)
  nz = np.abs(want.qM[0].numpy()) > 0
  dense = np.array([[(mask[i, j >> 5] >> np.uint32(j & 31)) & 1 for j in
                     range(tree.nv)] for i in range(tree.nv)], bool)
  assert not (np.tril(nz) & ~dense).any()


def test_float_table_is_built_once_per_model():
  m = tphys.put_model(g1_flat_arrays(), device='cpu', dtype=torch.float32)
  plan = tsk.plan_of(m)
  assert tsk.plan_of(m) is plan  # a second launch reuses it
  assert plan.ftab.numel() == plan.dims[13]
  mass_at = plan.dims[-7] + 17  # bconst: 18 floats a body, mass last
  assert plan.ftab[mass_at + 18] == m.body_mass[1]
  # a model whose body_mass differs gets its own table
  heavy = m.replace(body_mass=m.body_mass * 2)
  plan2 = tsk.plan_of(heavy)
  assert plan2 is not plan
  assert plan2.ftab[mass_at + 18] == 2 * m.body_mass[1]
  assert tsk.plan_of(m) is plan
  # and so does a model whose field is written in place, or assigned
  m.body_mass.mul_(3)
  plan3 = tsk.plan_of(m)
  assert plan3 is not plan and plan3.ftab[mass_at + 18] == m.body_mass[1]
  m.dof_armature = m.dof_armature + 1
  assert tsk.plan_of(m) is not plan3
  assert torch.equal(tsk.plan_of(m).ftab[plan.dims[-2]:plan.dims[-1]],
                     m.dof_armature)
  assert plan.etab is None and plan.env_batch == 0 and plan.dims[15] == 0

  # per-env segments: body_mass and qpos0 with an env axis put the bconst
  # and qpos0 segments into a per-env table, one row an env, and out of the
  # shared one; the other segments stay shared
  n, nb, nq = 3, m.stat.nbody, m.stat.nq
  e = expand_model_fields(
      tphys.put_model(g1_flat_arrays(), device='cpu', dtype=torch.float32),
      ['body_mass', 'qpos0', 'dof_damping'], n)
  e.body_mass[1, 1] *= 2  # env 1's pelvis
  pe = tsk.plan_of(e)
  assert tsk.plan_of(e) is pe
  assert pe.env_batch == n and pe.dims[15] == 0b010001  # bconst, qpos0
  assert tuple(pe.etab.shape) == (n, 18 * nb + nq) == (n, pe.dims[14])
  assert pe.ftab.numel() == plan.ftab.numel() - 18 * nb - nq
  assert pe.etab[1, pe.dims[-7] + 18 + 17] == 2 * pe.etab[0, 18 + 17]
  assert torch.equal(pe.etab[:, pe.dims[-3]:pe.dims[-3] + nq], e.qpos0)
  assert torch.equal(pe.ftab[pe.dims[-2]:pe.dims[-1]], e.dof_armature)
  # the shared table is the shared-table plan's without those segments
  full = tsk.plan_of(tphys.put_model(g1_flat_arrays(), device='cpu')).ftab
  d = plan.dims
  assert torch.equal(pe.ftab, torch.cat([full[d[-6]:d[-3]], full[d[-2]:]]))
  # a write of a per-env field rebuilds it, in place or by replace
  e.body_mass[2, 3] += 1
  assert tsk.plan_of(e) is not pe
  e2 = e.replace(body_mass=e.body_mass * 1.1)
  assert tsk.plan_of(e2).etab[1, 18 + 17] == e2.body_mass[1, 1]
  with pytest.raises(ValueError, match='number of envs'):
    tsk.plan_of(e.replace(qpos0=e.qpos0[:2]))


def _variant_mjmodel(gravity_off):
  """The G1 flat MjModel with the joints of the kernel's edge-case gates
  turned into slide joints (compiled fields edited in place on a copy)."""
  mj = copy.copy(g1_flat_mjmodel())
  mj.jnt_type[list(K3_SLIDE_JOINTS)] = 2
  if gravity_off:
    mj.opt.disableflags |= 1 << 6
  return mj


@pytest.mark.parametrize('gravity_off', [False, True])
def test_plain_matches_xla_stages_on_slide_variants(gravity_off):
  """The variants the CUDA kernel is held against on the card go through
  both packages here, so the card's yardstick (plain_all) is itself held
  to the reference on the slide and gravity-off branches."""
  mj = _variant_mjmodel(gravity_off)
  jm, jd, tm, td = _setup(mj, g1_states)
  # the snapshot variant chip_smoke.py builds is this very model
  snap = g1_variant(ModelArrays.of(g1_flat_mjmodel()), slide=K3_SLIDE_JOINTS,
                    gravity_off=gravity_off)
  assert tphys.put_model(snap, device='cpu').stat == tm.stat
  assert tsk.tree_of(tm.stat).gravity_off == gravity_off
  assert tsf.enabled(tm.stat)
  ref = jax.jit(jax.vmap(jsf._xla_all, in_axes=(None, 0)))(jm, jd)
  got = tsf.plain_all(tm, td)
  _assert_fields(got, ref, TOL)
  # the branches are live: the variant moves the outputs
  base = tsf.plain_all(*_setup(g1_flat_mjmodel(), g1_states)[2:])
  assert float((got.xpos - base.xpos).abs().max()) > 1e-3
  if gravity_off:
    grav = tsf.plain_all(*_setup(_variant_mjmodel(False), g1_states)[2:])
    assert float((got.qfrc_bias - grav.qfrc_bias).abs().max()) > 1e-3


def test_plain_runs_without_sites():
  """The site-less variant of the gates: plain_all leaves Data's
  placeholder site row alone and agrees with the full model elsewhere."""
  arrays = g1_flat_arrays()
  m0 = tphys.put_model(arrays, device='cpu', dtype=torch.float64)
  m1 = tphys.put_model(g1_variant(arrays, drop_sites=True), device='cpu',
                       dtype=torch.float64)
  assert m1.stat.nsite == 0 and tsf.enabled(m1.stat)
  qpos, qvel, _ = g1_states(arrays, 2, 0)
  d0 = tphys.make_batched_data(m0, 2, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  d1 = tphys.make_batched_data(m1, 2, device='cpu').replace(
      qpos=torch.as_tensor(qpos), qvel=torch.as_tensor(qvel))
  got, want = tsf.plain_all(m1, d1), tsf.plain_all(m0, d0)
  for f in FIELDS:
    if not f.startswith('site_'):
      assert torch.equal(getattr(got, f), getattr(want, f)), f
  assert got.site_xpos.shape == (2, 1, 3)
