"""The port's CUDA kernels against their plain versions on the card, at a
small batch of G1 flat envs, K3 also with per-env model constants (its
per-env form, with every segment per env, with config 5's and with the
tracking task's), at the Go1's shapes (n 18, 228 uncompacted contact
rows, trunks lying on the floor), on the G1 tracking env, and on the
convex pile (its ported collider groups card against CPU, K1-K3 at its
shapes, its launches a substep). They need an NVIDIA GPU and the CUDA
toolkit and skip elsewhere; `python3 chip_smoke.py` holds the kernels at
the main path's full shapes."""

import pytest
import torch

import mjlab_torch.physics as tphys
from chip_smoke import (
    PILE_GROUPS,
    PILE_LAUNCHES,
    g1_states,
    go1_card_vs_cpu,
    go1_floor_states,
    k3_rel_err,
    k3_variants,
    pair_name,
    per_env_k3_model,
    pile_states,
    random_newton_args,
    tracking_card_vs_cpu,
)
from mjlab_torch.asset_zoo import oracle_models as om
from mjlab_torch.asset_zoo import (
    g1_flat_arrays,
    go1_flat_arrays,
    tracking_arrays,
)
from mjlab_torch.ops import LAUNCHES
from mjlab_torch.ops import newton as tnewton
from mjlab_torch.ops import pd_solve as tpd
from mjlab_torch.ops import smooth_kernel as tsk
from mjlab_torch.physics import collision as tcol
from mjlab_torch.physics import constraint, linalg, pipeline, smooth
from mjlab_torch.physics import kinematics as tkin
from mjlab_torch.physics import smooth_fused, solver
from mjlab_torch.sim.sim import expand_model_fields

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


def _smooth_both(m, d, **shape):
  got = tsk.smooth_fused_cuda(m, d.qpos, d.qvel, **shape)
  return k3_rel_err(torch, got, smooth_fused.plain_all(m, d), m.stat.nsite)


@pytest.mark.parametrize('batch', [1, 33, 132 * 3 + 1, 4099])
def test_smooth_kernel_small_and_ragged_batches(g1, batch):
  """A batch need not fill its last block (the wrapper takes 1, 1, 4 and 16
  envs a block here on 132 SMs): the warps past its end stay alive and
  store nothing."""
  m, d = g1
  gen = torch.Generator().manual_seed(batch)
  d = g1_states(torch, tphys, g1_flat_arrays(), m, batch, 0.0, gen)
  assert _smooth_both(m, d) < TOL


def test_smooth_kernel_spinning_root(g1):
  """A free joint's rotational dofs see the parent and the translational
  velocity, not each other (the segment rule of cdof_dot)."""
  m, d = g1
  qvel = d.qvel.clone()
  qvel[:, 3:6] = torch.tensor([7.0, -4.0, 9.0], device='cuda')
  assert _smooth_both(m, d.replace(qvel=qvel)) < TOL


@pytest.mark.parametrize('variant', ['slide', 'slide, gravity off',
                                     'no sites'])
def test_smooth_kernel_model_variants(g1, variant):
  """Branches the G1 itself never takes: slide joints, the gravity disable
  bit, a model without sites."""
  arrays = k3_variants(g1_flat_arrays())[variant]
  m = tphys.put_model(arrays)
  assert smooth_fused.enabled(m.stat)
  gen = torch.Generator().manual_seed(7)
  d = g1_states(torch, tphys, arrays, m, 33, 0.0, gen)
  assert _smooth_both(m, d) < TOL
  # through the dispatch a site-less model keeps Data's placeholder row
  out = smooth_fused.smooth_all(m, d)
  assert out.site_xpos.shape[1] == max(m.stat.nsite, 1)
  assert out.geom_xpos.shape[1] == m.stat.ngeom


@pytest.mark.parametrize('envs_per_block', [1, 3, 16, 32])
def test_smooth_kernel_envs_a_block(g1, envs_per_block):
  """A warp works on an env whatever the number of warps a block; B = 64
  is no multiple of 3."""
  m, d = g1
  assert _smooth_both(m, d, envs_per_block=envs_per_block) < TOL


def test_smooth_kernel_fit_rule(g1, monkeypatch):
  """The library owns the layout: fewer envs go into a block when the
  number asked for does not fit, and a model of which one env does not fit
  raises (no way from a CUDA tensor to the plain version)."""
  _, d = g1
  one = tsk.smooth_smem_bytes(g1[0], 1)
  env = tsk.smooth_smem_bytes(g1[0], 2) - one  # an env's slice
  assert 8 * 1024 < env < 20 * 1024 and one - env < 12 * 1024
  assert tsk.smooth_smem_bytes(g1[0], 8) == one + 7 * env
  m = tphys.put_model(g1_flat_arrays())  # a plan of its own
  monkeypatch.setattr(tsk, 'SMEM_LIMIT', one + env + env // 2)
  assert _smooth_both(m, d, envs_per_block=8) < TOL
  assert tsk.plan_of(m).fits[8] == 2
  m = tphys.put_model(g1_flat_arrays())
  monkeypatch.setattr(tsk, 'SMEM_LIMIT', one - 4)
  with pytest.raises(ValueError, match='shared memory'):
    tsk.smooth_fused_cuda(m, d.qpos, d.qvel)


# ---- K3's per-env form (per-env domain randomization) ----------------------


def _per_env_both(m, d, **kw):
  """A per-env model of `m` (chip_smoke.per_env_k3_model) through the
  kernel, which must take its per-env form once, against plain_all."""
  me = per_env_k3_model(torch, m, d.qpos.shape[0],
                        torch.Generator().manual_seed(11), **kw)
  before = (LAUNCHES['smooth'], LAUNCHES['smooth_env'])
  err = _smooth_both(me, d)
  assert (LAUNCHES['smooth'], LAUNCHES['smooth_env']) == (
      before[0], before[1] + 1)
  return me, err


@pytest.mark.parametrize('batch', [33, 4096, 4099])
def test_smooth_kernel_per_env_matches_plain(g1, batch):
  """Every segment of the float table per env, at a ragged batch and at the
  main path's 4096."""
  m, _ = g1
  gen = torch.Generator().manual_seed(batch)
  d = g1_states(torch, tphys, g1_flat_arrays(), m, batch, 0.0, gen)
  me, err = _per_env_both(m, d)
  assert err < TOL
  assert tsk.plan_of(me).dims[15] == 0b111111


def test_smooth_kernel_per_env_body_mass_alone(g1):
  """Config 5's case: only body_mass per env, so only bconst."""
  m, d = g1
  me, err = _per_env_both(m, d, fields=('body_mass',))
  assert err < TOL
  assert tsk.plan_of(me).dims[15] == 1


@pytest.mark.parametrize('variant', ['slide', 'slide, gravity off',
                                     'no sites'])
def test_smooth_kernel_per_env_model_variants(g1, variant):
  arrays = k3_variants(g1_flat_arrays())[variant]
  m = tphys.put_model(arrays)
  d = g1_states(torch, tphys, arrays, m, 33, 0.0,
                torch.Generator().manual_seed(8))
  assert _per_env_both(m, d)[1] < TOL


def test_smooth_kernel_per_env_plan_once_and_after_randomize(g1,
                                                               monkeypatch):
  """The per-env table is built once per Model: launches on one Model
  reuse it; `randomize_field` makes a new Model, whose first launch builds
  its own, with the new values."""
  from mjlab_torch.envs.mdp import randomize_field
  from mjlab_torch.managers.term_cfg import SceneEntityCfg
  from mjlab_torch.tasks import registry
  m, d = g1
  env = registry.make('Mjlab-Velocity-Flat-Unitree-G1',
                      **{'scene.num_envs': B})
  me = expand_model_fields(m, ['body_mass'], B)
  built = []
  init = tsk._Plan.__init__
  monkeypatch.setattr(tsk._Plan, '__init__',
                      lambda self, mm: (built.append(mm), init(self, mm))[1])
  for _ in range(3):
    tsk.smooth_fused_cuda(me, d.qpos, d.qvel)
  assert len(built) == 1
  mask = torch.arange(B, device='cuda') % 2 == 0
  pelvis = SceneEntityCfg('robot', body_names=['pelvis']).resolve(env.scene)
  m2 = randomize_field(me, env.scene, torch.Generator(device='cuda'), mask,
                       field='body_mass', ranges=(2.0, 2.0),
                       operation='scale', asset_cfg=pelvis)
  assert _smooth_both(m2, d) < TOL
  assert len(built) == 2 and built[-1] is m2
  etab = tsk.plan_of(m2).etab
  assert torch.equal(etab[mask, 18 + 17], 2 * m.body_mass[1].expand(B // 2))
  assert torch.equal(etab[~mask, 18 + 17], m.body_mass[1].expand(B // 2))
  assert tsk.plan_of(me) is not tsk.plan_of(m2) and len(built) == 2


def test_smooth_kernel_forms_take_16_envs_a_block(g1):
  """The module asks for 16 envs a block. On the G1 with its 35 visual
  mesh geoms (69 geoms: one env's frame staging grows by 35 geom frames)
  the shared-table form fits 14; the per-env form at least as many, with
  less shared memory (its per-env segments are read from global
  memory)."""
  m, d = g1
  lib = tsk._build.library(tsk.NAME)
  me = per_env_k3_model(torch, m, B, torch.Generator().manual_seed(1))
  epb = tsk.ENVS_PER_BLOCK
  assert epb == 16 and m.stat.ngeom == 69
  fit = tsk._fit(lib, tsk.plan_of(m), epb)
  assert fit == 14
  assert tsk._fit(lib, tsk.plan_of(me), epb) >= fit
  shared = tsk.smooth_smem_bytes(m, fit)
  per_env = tsk.smooth_smem_bytes(me, fit)
  assert shared <= tsk.SMEM_LIMIT
  # the per-env segments leave the shared table (gravity stays)
  gone = tsk.plan_of(m).ftab.numel() - tsk.plan_of(me).ftab.numel()
  assert gone == tsk.plan_of(me).etab.shape[1] and 0 < shared - per_env <= \
      4 * gone
  assert _smooth_both(me, d, envs_per_block=fit) < TOL
  assert tsk.smooth_num_regs(False) > 0 and tsk.smooth_num_regs(True) > 0


@pytest.mark.parametrize('batch', [33, 4096])
def test_smooth_kernel_per_env_at_tracking_segments(g1, batch):
  """The tracking task's startup randomization on its own scene: body_ipos
  and qpos0 per env, so the bconst and qpos0 segments (bits 0 and 4)."""
  arrays = tracking_arrays()
  m = tphys.put_model(arrays)
  d = g1_states(torch, tphys, arrays, m, batch, 0.0,
                torch.Generator().manual_seed(batch))
  me, err = _per_env_both(m, d, fields=('body_ipos', 'qpos0'))
  assert err < TOL
  assert tsk.plan_of(me).dims[15] == 0b10001


def test_smooth_kernel_per_env_batch_must_match(g1):
  m, d = g1
  me = expand_model_fields(m, ['qpos0'], B + 1)
  with pytest.raises(ValueError, match='per-env fields'):
    tsk.smooth_fused_cuda(me, d.qpos, d.qvel)


def test_pd_solve_kernel_matches_plain(g1):
  m, d = g1
  d = smooth_fused.plain_all(m, d)
  g = torch.randn(B, m.stat.nv, device='cuda')
  assert _rel(tpd.solve_pd_cuda(d.qM, g), linalg.solve_pd(d.qM, g)) < TOL


@pytest.mark.parametrize('batch', [1, 33, 4096])
@pytest.mark.parametrize('n', [1, 3, 18, 35, 64])
def test_pd_solve_kernel_any_n_and_ragged_batch(g1, n, batch):
  """One lane owns one row of the factor, then two (n >= 32), then more
  (n = 64 with its right-hand side row); a batch need not fill a block."""
  gen = torch.Generator(device='cuda').manual_seed(n * 10000 + batch)
  A = torch.randn(batch, n, n, generator=gen, device='cuda')
  H = A @ A.transpose(1, 2) + 0.5 * torch.eye(n, device='cuda')
  g = torch.randn(batch, n, generator=gen, device='cuda')
  assert _rel(tpd.solve_pd_cuda(H, g), linalg.solve_pd(H, g)) < TOL


def test_pd_solve_kernel_raises_above_its_limit(g1):
  n = tpd.max_n() + 1
  assert n == 336  # the factor of 335 fills one block's shared memory
  H = torch.eye(n, device='cuda').expand(2, n, n).contiguous()
  with pytest.raises(ValueError, match=f'n <= {n - 1}'):
    tpd.solve_pd_cuda(H, torch.ones(2, n, device='cuda'))
  x = tpd.solve_pd_cuda(H[:, :n - 1, :n - 1].contiguous(),
                        torch.ones(2, n - 1, device='cuda'))
  assert _rel(x, torch.ones_like(x)) < TOL


@pytest.fixture(scope='module')
def newton_inputs(g1):
  m, d = g1
  d = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  d = smooth.fwd_smooth(m, smooth.actuation(m, d))
  efc = constraint.make_efc(m, d)
  assert efc['c_active'].any()
  args = [t.contiguous() for t in solver.newton_args(d, efc)]
  return args, solver.solver_params(m.stat)


def _newton_both(args, params, iterations=None):
  iters, polish, ldof, th = params
  iters = iters if iterations is None else iterations
  got = tnewton.newton_solve_cuda(*args, iterations=iters, ls_polish=polish,
                                  ldof=ldof, grad_th=th)
  return got, solver.newton_plain(*args, iters, polish, ldof, th)


def _rel_all(got, want):
  return max(_rel(g, w) for g, w in zip(got, want) if w.numel())


def test_newton_kernel_matches_plain(newton_inputs):
  got, want = _newton_both(*newton_inputs)
  for g, w in zip(got, want):
    assert _rel(g, w) < 1e-3


@pytest.mark.parametrize('rows', [slice(0, 1), slice(5, 38)])
def test_newton_kernel_small_and_ragged_batches(newton_inputs, rows):
  args, params = newton_inputs
  got, want = _newton_both([t[rows].contiguous() for t in args], params)
  assert _rel_all(got, want) < 1e-3


def test_newton_kernel_contact_free_envs(newton_inputs):
  args, params = newton_inputs
  args = [t.clone() for t in args]
  args[6][::3] = False  # c_active
  args[5][::3] = 0.0  # c_D is zero on inactive rows, as make_efc leaves it
  got, want = _newton_both(args, params)
  assert all(bool(torch.isfinite(g).all()) for g in got)
  assert not bool(got[3][::3].any())  # no force on inactive rows
  assert _rel_all(got, want) < 1e-3


@pytest.mark.parametrize('n', [64, 70])
def test_newton_kernel_many_rows_a_lane(g1, n):
  """n + 1 > 64: a lane of the factorization owns more than two rows of the
  Hessian, and cJ's row stride passes 36 floats. No model of the repo is
  that wide, so random problems (chip_smoke.py's generator) hold that
  variant of the kernel against the plain solver."""
  m, _ = g1
  iters, polish, _, th = solver.solver_params(m.stat)
  gen = torch.Generator(device='cuda').manual_seed(n)
  args, ldof = random_newton_args(torch, 33, n, 48, 20, gen)
  assert tnewton.fits(n, 48, 20)
  got, want = _newton_both(args, (iters, polish, ldof, th))
  assert all(bool(torch.isfinite(g).all()) for g in got)
  assert _rel_all(got, want) < 1e-3


def test_newton_kernel_masks_must_be_bool(newton_inputs):
  args, params = newton_inputs
  bad = list(args)
  bad[6] = bad[6].float()
  with pytest.raises(TypeError, match='c_act must be torch.bool'):
    _newton_both(bad, params)


def test_newton_kernel_ignores_the_cap_once_frozen(newton_inputs):
  """With a threshold float32 can reach, envs freeze within the cap; the
  kernel then leaves its loop, so caps of 10 and 30 agree on every env the
  plain solver finds frozen one step before the cap (to 1e-5: the kernel's
  own gradient may cross the threshold a step away from the plain one's),
  and most of them bit for bit."""
  args, (iters, polish, ldof, _) = newton_inputs
  params = (iters, polish, ldof, 1e-2)
  x, ff, fl, fc = solver.newton_plain(*args, iters - 1, polish, ldof, 1e-2)
  jt = (ff + torch.einsum('bcv,bc->bv', args[3], fc)).index_add(
      1, torch.as_tensor(ldof, device='cuda'), args[7] * fl)
  grad = torch.einsum('bij,bj->bi', args[0], x - args[1]) - jt
  frozen = (grad * grad).sum(-1) <= 1e-4
  assert int(frozen.sum()) >= B // 2
  short, want = _newton_both(args, params)
  full, _ = _newton_both(args, params, iterations=3 * iters)
  assert _rel_all([t[frozen] for t in short], [t[frozen] for t in full]) < 1e-5
  same = torch.stack([(a == b).all(-1) for a, b in zip(short, full)]).all(0)
  assert int(same[frozen].sum()) >= int(frozen.sum()) // 2
  assert _rel_all(short, want) < 1e-3


def test_env_step_on_the_card_matches_the_cpu(g1):
  """The G1 flat env under the degenerate-range configuration, 8 envs and 5
  env-steps with one forced reset: CUDA float32 (the kernels feed every
  observation and reward) against the CPU in float64 (their plain
  versions)."""
  from chip_smoke import env_card_vs_cpu
  e_obs, e_rew, flags_equal, resets = env_card_vs_cpu(torch)
  assert e_obs <= 1e-3 and e_rew <= 1e-3
  assert flags_equal and resets >= 1


def test_env_step_waits_for_the_card_once(g1):
  """`bool(done.any())` of the conditional refresh is the one synchronizing
  call of an env-step on the card."""
  import warnings

  from mjlab_torch.tasks import registry
  env = registry.make('Mjlab-Velocity-Flat-Unitree-G1',
                      **{'scene.num_envs': B})
  env.reset()
  act = torch.zeros((B, env.action_dim), device='cuda')
  env.step(act)  # first use builds the kernels' plans and the index tables
  torch.cuda.set_sync_debug_mode('warn')
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter('always')
      for _ in range(3):
        env.step(act)
  finally:
    torch.cuda.set_sync_debug_mode('default')
  syncs = [str(w.message) for w in caught if 'synchroniz' in str(w.message)]
  assert len(syncs) == 3, syncs


@pytest.fixture(scope='module')
def go1():
  """The Go1 flat Model on the card (float32) and 257 floor states (a
  ragged last block of K3's 16 envs), a third with the trunk flat on the
  floor."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  arrays = go1_flat_arrays()
  m = tphys.put_model(arrays)
  qpos, qvel = go1_floor_states(arrays.key_qpos[0], m.stat.nv, 257, seed=1)
  f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device='cuda')
  d = tphys.make_batched_data(m, 257).replace(
      qpos=f32(qpos), qvel=f32(qvel),
      ctrl=f32(arrays.key_ctrl[0]).expand(257, -1).contiguous())
  return m, d


def test_smooth_kernel_at_go1_shapes(go1):
  m, d = go1
  assert smooth_fused.enabled(m.stat)
  got = tsk.smooth_fused_cuda(m, d.qpos, d.qvel)
  want = smooth_fused.plain_all(m, d)
  for k in tsk.OUT_KEYS:
    assert _rel(got[k], getattr(want, k)) < TOL, k


def test_newton_kernel_at_go1_shapes(go1):
  m, d = go1
  d = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  d = smooth.fwd_smooth(m, smooth.actuation(m, d))
  efc = constraint.make_efc(m, d)
  assert tuple(efc['c_J'].shape[1:]) == (228, 18)
  assert bool(efc['c_active'][:, 212:228].any())  # the plane-box rows
  args = solver.newton_args(d, efc)
  iters, polish, ldof, grad_th = solver.solver_params(m.stat)
  assert tnewton.fits(18, 228, 12)
  got = tnewton.newton_solve_cuda(*args, iterations=iters, ls_polish=polish,
                                  ldof=ldof, grad_th=grad_th)
  want = solver.newton_plain(*args, iters, polish, ldof, grad_th)
  for g, w in zip(got, want):
    assert _rel(g, w) < 1e-3


def test_pd_solve_kernel_at_go1_shapes(go1):
  m, d = go1
  df = pipeline.forward(m, d)
  deriv = m.dof_damping - pipeline._actuator_vel_deriv(m, df)
  H = (df.qM + m.opt.timestep * torch.diag_embed(deriv)).contiguous()
  g = (df.qfrc_smooth + df.qfrc_constraint).contiguous()
  assert _rel(tpd.solve_pd_cuda(H, g), linalg.solve_pd(H, g)) < TOL


def test_go1_env_on_the_card_matches_the_cpu(go1):
  e_obs, e_rew, same, flips, kept = go1_card_vs_cpu(torch, 4, 3)
  assert e_obs <= 1e-3 and e_rew <= 1e-3 and same
  assert all(g <= 1e-6 for _, g in flips.values()) and kept >= 3


# ---- the G1 tracking env -----------------------------------------------------


def test_tracking_env_step_launches_each_kernel(g1):
  """An env-step of the tracking env launches K3 in its per-env form 4
  times (body_ipos and qpos0 per env), K2 4 and K1 8, with one more of K3
  and K2 and K1 where an env resets; never K3's shared form."""
  from mjlab_torch.tasks import registry
  env = registry.make('Mjlab-Tracking-Flat-Unitree-G1',
                      **{'scene.num_envs': B})
  env.reset()
  kernels = ('smooth_env', 'newton', 'pd_solve', 'smooth')
  seen = set()
  for _ in range(3):
    before = [LAUNCHES[k] for k in kernels]
    env.step(torch.zeros(B, env.action_dim, device='cuda'))
    seen.add(tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)))
  assert seen <= {(4, 4, 8, 0), (5, 5, 9, 0)}, seen


def test_tracking_env_on_the_card_matches_the_cpu(g1):
  """chip_smoke phase 9d at 8 envs and 5 env-steps."""
  e_obs, e_rew, same, flips, kept = tracking_card_vs_cpu(torch)
  assert e_obs <= 1e-3 and e_rew <= 1e-3 and same
  assert all(g <= 1e-6 for _, g in flips.values()) and kept >= 6


# ---- the convex pile --------------------------------------------------------


@pytest.fixture(scope='module')
def pile():
  """The convex pile's Model on the card (float32) and B of chip_smoke's
  seeded start states stepped 20 substeps into their first contacts, and
  the same Model on the CPU in float64."""
  if not torch.cuda.is_available():
    pytest.skip('needs an NVIDIA GPU')
  arrays = om.oracle_arrays('convex_pile')
  m = tphys.put_model(arrays)
  qpos, qvel = pile_states(torch, m, B, seed=15)
  d = tphys.make_batched_data(m, B).replace(qpos=qpos, qvel=qvel)
  for _ in range(20):
    d = tphys.step(m, d)
  return m, d, tphys.put_model(arrays, device='cpu', dtype=torch.float64)


@pytest.mark.parametrize('name', PILE_GROUPS)
def test_pile_group_on_the_card_matches_the_cpu(pile, name):
  """Each collider group this slice ported, card float32 against CPU
  float64 on the same poses: finite, and dist within 1e-4 m and the
  normal within 1e-3 on all but 2 % of the (env, pair, point) slots (a
  convex core's deep/shallow branch turns on a sliver of overlap that
  float32 may read on the other side)."""
  m, d, mc = pile
  key = next(k for k in m.stat.pairs.groups if pair_name(k) == name)
  g1s, g2s = m.stat.pairs.groups[key][:2]
  dc = tkin.kinematics(mc, tphys.make_batched_data(mc, B, device='cpu')
                       .replace(qpos=d.qpos.cpu().double()))
  got = tcol.group_collider(m, key, g1s, g2s)(tkin.kinematics(m, d))
  want = tcol.group_collider(mc, key, g1s, g2s)(dc)
  assert all(bool(torch.isfinite(x).all()) for x in got)
  bad = ((got[0].cpu().double() - want[0]).abs() > 1e-4) | (
      (got[2].cpu().double() - want[2]).abs().amax(-1) > 1e-3)
  assert float(bad.double().mean()) <= 0.02, float(bad.double().mean())


def test_kernels_at_pile_shapes(pile):
  """K3 (ten bodies, nine free joints on the world), K2 (n 54, 248
  contact rows) and K1 (n 54) against their plain versions on the pile's
  states."""
  m, d, _ = pile
  s = m.stat
  assert smooth_fused.enabled(s)
  got = tsk.smooth_fused_cuda(m, d.qpos, d.qvel)
  assert k3_rel_err(torch, got, smooth_fused.plain_all(m, d), s.nsite) < TOL
  df = pipeline.fwd_velocity(m, pipeline.fwd_position(m, d))
  df = smooth.fwd_smooth(m, smooth.actuation(m, df))
  efc = constraint.make_efc(m, df)
  assert tuple(efc['c_J'].shape[1:]) == (248, 54)
  assert bool(efc['c_active'].any())
  args = solver.newton_args(df, efc)
  iters, polish, ldof, grad_th = solver.solver_params(s)
  assert tnewton.fits(54, 248, len(ldof))
  out = tnewton.newton_solve_cuda(*args, iterations=iters, ls_polish=polish,
                                  ldof=ldof, grad_th=grad_th)
  want = solver.newton_plain(*args, iters, polish, ldof, grad_th)
  for g, w in zip(out, want):
    assert _rel(g, w) < 1e-3
  dfw = pipeline.forward(m, d)
  H = (dfw.qM + m.opt.timestep * torch.diag_embed(
      m.dof_damping.expand_as(dfw.qvel))).contiguous()
  g = (dfw.qfrc_smooth + dfw.qfrc_constraint).contiguous()
  assert _rel(tpd.solve_pd_cuda(H, g), linalg.solve_pd(H, g)) < TOL


def test_pile_launches_each_kernel_a_substep(pile):
  """A substep of the pile launches (K3, K2, K1) as chip_smoke's
  PILE_LAUNCHES: K3 and K2 once, K1 in fwd_smooth and in the Euler
  step's implicit damping."""
  m, d, _ = pile
  kernels = ('smooth', 'newton', 'pd_solve')
  before = [LAUNCHES[k] for k in kernels]
  tphys.step(m, d)
  assert tuple(LAUNCHES[k] - b for k, b in zip(kernels, before)) \
      == PILE_LAUNCHES
