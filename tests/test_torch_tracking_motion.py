"""The tracking task's motion pipeline and motion command in the port
against the JAX package: the frame math of utils/math.py (float64,
1e-12), scripts/motion.py (resampling bit for bit; forward kinematics,
ground clearance, the synthetic clips and csv_to_npz against the JAX
package's CPU MuJoCo pipeline, 1e-5), the committed tracking scene
snapshot against a fresh compile and the JAX env's model, and
MotionCommand's adaptive start sampling and per-step update against the
JAX term on one state (1e-7), with the distribution of the port's start
draw checked on the port alone."""

import os
import types

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import G1_TRACKING, tracking_arrays
from mjlab_torch.asset_zoo.pretrained import G1_TRACKING_MOTION
from mjlab_torch.physics import io as tio
from mjlab_torch.physics import sensor as tsensor
from mjlab_torch.scene import snapshot as tsnap
from mjlab_torch.scripts import motion as tmotion
from mjlab_torch.utils import math as tmath
from mjlab_tpu.scripts import motion as jmotion
from mjlab_tpu.utils import math as jmath
from torch_parity import g1_tracking_mjmodel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK = os.path.join(ROOT, 'artifacts', 'motions', 'g1_walk_turn_50hz')
TOL = 1e-5


def _quats(rng, *shape):
  q = rng.normal(size=shape + (4,))
  return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(fn_t, fn_j, *args):
  got = fn_t(*(torch.as_tensor(a) for a in args))
  want = fn_j(*(jnp.asarray(a) for a in args))
  if isinstance(got, tuple):
    return [g.numpy() for g in got], [np.asarray(w) for w in want]
  return [got.numpy()], [np.asarray(want)]


@pytest.mark.parametrize('name', [
    'quat_inv', 'yaw_quat', 'quat_error_magnitude', 'matrix_from_quat',
    'combine_frame_transforms', 'subtract_frame_transforms'])
def test_frame_math_matches_jax(name):
  """Each addition to utils/math.py on random and edge inputs (a yaw
  quaternion's guard at w = z = 0, broadcast frames, absent offsets)."""
  rng = np.random.default_rng(0)
  q1, q2 = _quats(rng, 64), _quats(rng, 5, 64)
  p1, p2 = rng.normal(size=(64, 3)), rng.normal(size=(5, 64, 3))
  ft, fj = getattr(tmath, name), getattr(jmath, name)
  if name in ('quat_inv', 'matrix_from_quat'):
    cases = [(q1,), (3.0 * q2,)]
  elif name == 'yaw_quat':
    edge = q1.copy()
    edge[:8, 0] = edge[:8, 3] = 0.0
    cases = [(q1,), (edge,)]
  elif name == 'quat_error_magnitude':
    cases = [(q1, q2), (q1, q1), (q1, -q1)]
  else:
    cases = [(p1, q1, p2, q2), (p1, q1)]
  for args in cases:
    if name.endswith('frame_transforms') and len(args) == 4:
      args = (p1[None], q1[None], p2, q2)
    got, want = _both(ft, fj, *args)
    for g, w in zip(got, want):
      np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, err_msg=name)


def test_resample_qpos_is_the_jax_packages():
  rng = np.random.default_rng(1)
  qpos = rng.normal(size=(31, 36))
  qpos[:, 3:7] = _quats(rng, 31)
  for fps in ((30.0, 50.0), (60.0, 50.0), (50.0, 50.0)):
    np.testing.assert_array_equal(
        tmotion.resample_qpos(qpos, *fps, quat_cols=[3]),
        jmotion.resample_qpos(qpos, *fps, quat_cols=[3]))


def _jax_robot():
  """The JAX package's G1 compiled alone, as its motion pipeline does."""
  from mjlab_tpu.asset_zoo.unitree_g1 import G1_ROBOT_CFG
  from mjlab_tpu.entity.entity import Entity
  ent = Entity(G1_ROBOT_CFG)
  mj = ent.spec.compile()
  return mj, ent.compute_indexing(mj, '')


def _trajectory(rng, T):
  """T frames near the keyframe with a turning, bobbing root."""
  mj = tracking_arrays()
  qpos = np.tile(mj.key_qpos[0], (T, 1))
  qpos[:, 7:] += 0.3 * rng.normal(size=(T, mj.nq - 7))
  qpos[:, :3] += 0.05 * rng.normal(size=(T, 3))
  qpos[:, 2] -= 0.1
  qpos[:, 3:7] = _quats(rng, T) * 0.1 + np.array([1.0, 0, 0, 0])
  qpos[:, 3:7] /= np.linalg.norm(qpos[:, 3:7], axis=-1, keepdims=True)
  return qpos


def test_qpos_to_motion_and_ground_clearance_match_mujoco():
  """The port's forward kinematics of a trajectory on the tracking
  snapshot against CPU MuJoCo's `mj_kinematics` on the robot compiled
  alone (the JAX package's pipeline): every motion array, and the root
  lift of frames whose geoms dip below the plane (the scene's plane is
  not among the geoms the port bounds)."""
  rng = np.random.default_rng(2)
  qpos = _trajectory(rng, 40)
  jmj, jidx = _jax_robot()
  mj = tracking_arrays()
  idx = tmotion._robot(mj)
  assert list(idx.body_names) == list(jidx.body_names)
  assert len(idx.body_ids) == 30
  got = tmotion.qpos_to_motion(mj, idx.body_ids, idx.q_adr, qpos, 50.0,
                               device='cpu')
  want = jmotion.qpos_to_motion(jmj, list(jidx.body_names), jidx.q_adr,
                                jidx.free_q_adr, qpos, 50.0)
  assert sorted(got) == sorted(want)
  for k in want:
    assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)
  lift_t, lift_j = qpos.copy(), qpos.copy()
  tmotion.project_ground_clearance(mj, lift_t, 2, idx.geom_ids,
                                   device='cpu')
  jmotion.project_ground_clearance(jmj, lift_j, 2)
  assert (lift_t[:, 2] > qpos[:, 2]).sum() > 10
  np.testing.assert_allclose(lift_t, lift_j, rtol=0, atol=1e-12)


def test_synthetic_clips_match_the_jax_packages(tmp_path):
  """generate_g1_squat_motion (2 s) and generate_g1_walk_csv (2.5 s) of
  both packages."""
  a, b = str(tmp_path / 'port.npz'), str(tmp_path / 'jax.npz')
  tmotion.generate_g1_squat_motion(a, duration_s=2.0, device='cpu')
  jmotion.generate_g1_squat_motion(b, duration_s=2.0)
  with np.load(a) as got, np.load(b) as want:
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
      assert got[k].shape == want[k].shape
      np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                 err_msg=k)
  a, b = str(tmp_path / 'port.csv'), str(tmp_path / 'jax.csv')
  tmotion.generate_g1_walk_csv(a, duration_s=2.5, device='cpu')
  jmotion.generate_g1_walk_csv(b, duration_s=2.5)
  np.testing.assert_allclose(np.loadtxt(a, delimiter=','),
                             np.loadtxt(b, delimiter=','), rtol=0, atol=TOL)


def test_csv_to_npz_reproduces_the_committed_walk_clip(tmp_path):
  """The port's csv_to_npz of the committed CSV is the committed clip the
  shipped tracking policy was trained on (499 frames, 30 bodies), and the
  copy shipped beside the policy is that clip."""
  out = tmotion.csv_to_npz(WALK + '.csv', str(tmp_path / 'walk.npz'),
                           device='cpu')
  with np.load(out) as got, np.load(WALK + '.npz') as want, \
       np.load(G1_TRACKING_MOTION) as shipped:
    assert want['body_pos_w'].shape == (499, 30, 3)
    assert sorted(got.files) == sorted(want.files) == sorted(shipped.files)
    for k in want.files:
      np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL,
                                 err_msg=k)
      np.testing.assert_array_equal(shipped[k], want[k], err_msg=k)


def test_motion_cli_writes_the_squat(tmp_path, monkeypatch):
  """The squat through the CLI, with `--render`: the kinematic replay of
  the clip written, here by a stand-in renderer without a GL context as
  the qpos it was given, which is the JAX script's replay of the same
  clip."""

  class NoGl:
    def __init__(self, *a, **k):
      raise RuntimeError('no GL context (stand-in)')

  monkeypatch.setattr(mujoco, 'Renderer', NoGl)
  out = tmotion.main(['--synthetic-squat', '--output',
                      str(tmp_path / 'squat.npz'), '--device', 'cpu',
                      '--render', str(tmp_path / 'squat.mp4')])
  with np.load(out) as z:
    assert z['joint_pos'].shape == (400, 29)
  from mjlab_tpu.asset_zoo.unitree_g1 import G1_ROBOT_CFG
  jmotion._render_motion(out, G1_ROBOT_CFG, str(tmp_path / 'jax.mp4'), 50.0)
  got = np.load(tmp_path / 'squat.mp4.qpos.npy')
  assert got.shape == (400, 1, 36)
  np.testing.assert_array_equal(got, np.load(tmp_path / 'jax.mp4.qpos.npy'))


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------


def test_tracking_snapshot_matches_fresh_compile():
  fresh = tsnap.snapshot(G1_TRACKING).arrays()
  saved = tracking_arrays().arrays()
  assert sorted(fresh) == sorted(saved)
  for k in fresh:
    np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)


def _names(m, objtype, ids):
  return [mujoco.mj_id2name(m, objtype, int(i)) for i in ids]


def test_tracking_scene_matches_jax_env():
  """Every physics field of the port's tracking scene equals the JAX
  tracking env's, all 69 geoms (the 35 visual mesh geoms among them)
  compared by id; one contact sensor,
  `self_collision`, the subtree of the pelvis against itself (found,
  netforce, 10), matching the same 469 robot-robot slots."""
  port, env = tsnap.model(G1_TRACKING), g1_tracking_mjmodel()
  for f in ('nq', 'nv', 'nu', 'nbody', 'njnt', 'nsensor', 'nsensordata',
            'nkey'):
    assert getattr(port, f) == getattr(env, f), f
  prefixes = ('body_', 'jnt_', 'dof_', 'actuator_', 'sensor_')
  for f in tio.SNAPSHOT_ARRAYS:
    if f.startswith(prefixes):
      np.testing.assert_allclose(getattr(port, f), getattr(env, f),
                                 rtol=1e-12, atol=1e-12, err_msg=f)
  body = mujoco.mjtObj.mjOBJ_BODY
  assert _names(port, mujoco.mjtObj.mjOBJ_SENSOR, [0]) == ['robot/self_collision']
  assert _names(port, body, port.sensor_objid) == ['robot/pelvis']
  assert list(port.sensor_intprm[0, :3]) == [1, 3, 10]
  assert port.ngeom == env.ngeom == 69
  for f in ('geom_type', 'geom_bodyid', 'geom_size', 'geom_pos',
            'geom_quat', 'geom_friction', 'geom_condim', 'geom_priority',
            'geom_contype', 'geom_conaffinity', 'geom_solref',
            'geom_solimp', 'geom_solmix', 'geom_margin', 'geom_gap',
            'geom_group', 'geom_dataid'):
    np.testing.assert_array_equal(getattr(port, f), getattr(env, f),
                                  err_msg=f)
  np.testing.assert_array_equal(port.key_qpos, env.key_qpos)
  geom = mujoco.mjtObj.mjOBJ_GEOM
  slot_pairs = []
  for mj in (port, env):
    s = tphys.put_model(mj, device='cpu').stat
    cs = tsensor._contact_sensors(s)[0]
    slot_pairs.append(sorted(zip(
        _names(mj, geom, np.asarray(s.con_geom1)[cs.slots]),
        _names(mj, geom, np.asarray(s.con_geom2)[cs.slots]))))
  assert slot_pairs[0] == slot_pairs[1] and len(slot_pairs[0]) == 469


# ---------------------------------------------------------------------------
# the motion command on one state, against the JAX term
# ---------------------------------------------------------------------------

NB = 30  # the G1's bodies; the clip's body axis


class _View:
  """The few entity reads MotionCommand makes, over fixed arrays (robot
  body poses and joint state) converted by `conv`."""

  def __init__(self, names, arrays, conv):
    self.idx = types.SimpleNamespace(body_names=tuple(names))
    self._a = arrays
    self._conv = conv

  def _rows(self, key, ids):
    a = self._a[key]
    return self._conv(a if ids is None else a[:, np.asarray(ids)])

  def body_pos_w(self, d, body_ids=None):
    return self._rows('xpos', body_ids)

  def body_quat_w(self, d, body_ids=None):
    return self._rows('xquat', body_ids)

  def body_lin_vel_w(self, d, body_ids=None):
    return self._rows('lin', body_ids)

  def body_ang_vel_w(self, d, body_ids=None):
    return self._rows('ang', body_ids)

  def joint_pos(self, d):
    return self._conv(self._a['qj'])

  def joint_vel(self, d):
    return self._conv(self._a['vj'])


class _Scene:

  def __init__(self, view):
    self.view = view
    self.device = torch.device('cpu')
    self.model = types.SimpleNamespace(dtype=torch.float64)

  def __getitem__(self, name):
    return self.view


def _commands(n, kernel_size=3, seed=0):
  """(JAX MotionCommand, port MotionCommand, numpy robot arrays, env
  origins) on the shipped walk clip, adaptive sampling on with a kernel of
  `kernel_size`."""
  from mjlab_tpu.tasks.tracking.config.g1.flat_env_cfg import (
      ANCHOR_BODY, TRACKED_BODIES)
  from mjlab_tpu.tasks.tracking.mdp import commands as jcmd
  from mjlab_torch.tasks.tracking.mdp import commands as tcmd
  names = tmotion._robot(tracking_arrays()).body_names
  rng = np.random.default_rng(seed)
  arrays = {'xpos': rng.normal(size=(n, NB, 3)) + [0, 0, 0.8],
            'xquat': _quats(rng, n, NB), 'lin': rng.normal(size=(n, NB, 3)),
            'ang': rng.normal(size=(n, NB, 3)),
            'qj': rng.normal(size=(n, 29)), 'vj': rng.normal(size=(n, 29))}
  kw = dict(motion_file=str(G1_TRACKING_MOTION),
            anchor_body_name=ANCHOR_BODY, body_names=TRACKED_BODIES,
            adaptive_kernel_size=kernel_size, adaptive_alpha=0.1)
  jterm = jcmd.MotionCommand(
      jcmd.MotionCommandCfg(**kw), _Scene(_View(names, arrays, jnp.asarray)),
      n)
  tterm = tcmd.MotionCommand(
      tcmd.MotionCommandCfg(**kw),
      _Scene(_View(names, arrays, torch.as_tensor)), n)
  origins = rng.normal(size=(n, 3))
  return jterm, tterm, arrays, origins


def _state(jterm, tterm, n, seed=1):
  """One command state of both terms: failure counts in the bins, time
  steps away from the clip's end, random relative targets."""
  rng = np.random.default_rng(seed)
  jst = jterm.init_state(jax.random.PRNGKey(0))
  tst = tterm.init_state(torch.Generator().manual_seed(0))
  T = jterm.motion.time_step_total
  fresh = {'time_steps': rng.integers(0, T - 2, n).astype(np.int32),
           'bin_failed': rng.random(jterm.n_bins).astype(np.float32),
           'current_bin_failed': rng.integers(
               0, 5, jterm.n_bins).astype(np.float32),
           'body_pos_relative_w': rng.normal(size=(n, 14, 3)),
           'body_quat_relative_w': _quats(rng, n, 14)}
  jst = {**jst, **{k: jnp.asarray(v) for k, v in fresh.items()}}
  tst = {**tst, **{k: torch.as_tensor(v) for k, v in fresh.items()}}
  return jst, tst


def _ctx(conv, origins, terminated=None):
  # world: the env context's parallel.sharding.World, none for one process
  return types.SimpleNamespace(
      data=None, env_origins=conv(origins), world=None,
      terminated=None if terminated is None else conv(terminated))


@pytest.mark.parametrize('kernel_size', [1, 3])
def test_adaptive_probs_and_failures_match_jax(kernel_size):
  n = 64
  jterm, tterm, _, origins = _commands(n, kernel_size)
  assert tterm.n_bins == jterm.n_bins == 10
  jst, tst = _state(jterm, tterm, n)
  np.testing.assert_allclose(tterm._adaptive_probs(tst).numpy(),
                             np.asarray(jterm._adaptive_probs(jst)), rtol=0,
                             atol=1e-7)
  rng = np.random.default_rng(3)
  mask, term = rng.random(n) < 0.6, rng.random(n) < 0.5
  got = tterm._record_failures(
      tst, _ctx(torch.as_tensor, origins, term), torch.as_tensor(mask))
  want = jterm._record_failures(
      jst, _ctx(jnp.asarray, origins, term), jnp.asarray(mask))
  np.testing.assert_array_equal(got['current_bin_failed'].numpy(),
                                np.asarray(want['current_bin_failed']))
  assert float(got['current_bin_failed'].sum()) == float(
      jst['current_bin_failed'].sum()) + (mask & term).sum()


def test_compute_matches_jax():
  """One step of MotionCommand.compute on one state: the metrics (the
  sampling entropy and top-1 probability of the adaptive bins included),
  the advanced time steps, the yaw-aligned relative targets and the EMA of
  the failure bins (float32, as in the JAX package)."""
  n = 64
  jterm, tterm, _, origins = _commands(n)
  jst, tst = _state(jterm, tterm, n)
  got = tterm.compute(tst, _ctx(torch.as_tensor, origins),
                      torch.Generator().manual_seed(0), 0.02)
  want = jterm.compute(jst, _ctx(jnp.asarray, origins),
                       jax.random.PRNGKey(0), 0.02)
  assert sorted(got) == sorted(want)
  assert got['bin_failed'].dtype == torch.float32
  for k in want:
    np.testing.assert_allclose(got[k].numpy().astype(np.float64),
                               np.asarray(want[k], np.float64), rtol=0,
                               atol=1e-7, err_msg=k)
  np.testing.assert_array_equal(got['time_steps'].numpy(),
                                np.asarray(jst['time_steps']) + 1)
  assert float(got['metric/sampling_entropy'][0]) > 0.5


def test_start_draw_follows_the_adaptive_probabilities():
  """The port's draw of start steps (torch.multinomial, in place of
  jax.random.categorical) against the exact law of ((bin + U) / bins) *
  (T - 1) truncated, with `bin` from the adaptive probabilities: a
  chi-square test over cells of 10 steps, 200,000 draws."""
  from scipy import stats
  n = 200_000
  _, tterm, _, _ = _commands(n, kernel_size=3)
  fails = np.random.default_rng(4).random(tterm.n_bins) * 3.0
  tst = {**tterm.init_state(torch.Generator()),
         'bin_failed': torch.as_tensor(fails, dtype=torch.float32)}
  probs = tterm._adaptive_probs(tst).double().numpy()
  assert probs.max() > 2 * probs.min()
  ts, st = tterm._sample_time_steps(tst, torch.Generator().manual_seed(7))
  T, nb = tterm.motion.time_step_total, tterm.n_bins
  t = np.arange(T)
  # P(step = t | bin b) = |{u in [0, 1): t <= (b + u) (T - 1) / nb < t + 1}|
  edge = lambda x, b: np.clip(x * nb / (T - 1) - b, 0.0, 1.0)
  pmf = sum(p * (edge(t + 1, b) - edge(t, b)) for b, p in enumerate(probs))
  np.testing.assert_allclose(pmf.sum(), 1.0, atol=1e-12)
  cells = t // 10
  expected = np.bincount(cells, pmf) * n
  seen = np.bincount(cells[ts.numpy()], minlength=len(expected))
  chi2 = float(((seen - expected) ** 2 / expected).sum())
  assert chi2 < stats.chi2.ppf(0.9999, len(expected) - 1), chi2
  np.testing.assert_allclose(float(st['metric/sampling_top1_prob'][0]),
                             probs.max(), rtol=1e-6)
