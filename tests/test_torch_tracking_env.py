"""The G1 motion-tracking task (`Mjlab-Tracking-Flat-Unitree-G1`, BASELINE
config 4) in the port against the JAX package: reset and six env-steps of
both envs in float64 on one compiled model, with every sampling range
collapsed to a point (chip_smoke.tracking_degenerate_ranges), adaptive
start sampling off, and a clip cut to five frames so that the loop
resample at the clip's end runs; one env is tipped past `anchor_ori` (a
masked RSI reset) and one has its arm folded into the torso (the
`self_collision` sensor counts). The startup randomization writes
geom_friction, body_ipos and qpos0 per env, so K3's plain version runs
with per-env bconst and qpos0 segments."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from chip_smoke import (
    TRACK_TASK,
    TRACK_TIP,
    fold_arm_qpos,
    tip_over_state,
    tracking_degenerate_ranges,
)
from mjlab_torch.envs.io import env_state_to_numpy
from torch_parity import env_state_leaves, jax_env_f64

ROOT_CLIP = 'artifacts/motions/g1_walk_turn_50hz.npz'
N = 3
STEPS = 6
TIP_AT = 2  # env 1 is tipped over before this step
FOLD = 2  # env 2's arm is folded into its torso after the reset
FRAMES = 5
TOL = 1e-6


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
  """The walk clip's first five frames."""
  import os
  here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  with np.load(os.path.join(here, ROOT_CLIP)) as z:
    cut = {k: z[k][:FRAMES] for k in z.files}
  path = tmp_path_factory.mktemp('clip') / 'walk5.npz'
  np.savez(path, **cut)
  return str(path)


@pytest.fixture(scope='module')
def pair(clip):
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.tasks import registry as treg
  jenv = jax_env_f64(tracking_degenerate_ranges(
      jreg.load_cfg(TRACK_TASK), N, clip))
  tenv = treg.make(TRACK_TASK, cfg=tracking_degenerate_ranges(
      treg.load_cfg(TRACK_TASK), N, clip), device='cpu',
      dtype=torch.float64, mj_model=jenv.scene.mj_model)
  return jenv, tenv


def _close(got, want, what, tol=TOL):
  got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0, atol=tol,
                               err_msg=what)


def _same_tree(got, want, path):
  assert set(got) <= set(want), path
  for k, v in got.items():
    if isinstance(v, dict):
      _same_tree(v, want[k], f'{path}/{k}')
    else:
      _close(v, want[k], f'{path}/{k}')


def _set_qpos(jenv, tenv, qpos):
  js, ts = jenv.state, tenv.state
  jenv._state = js.replace(data=js.data.replace(qpos=jnp.asarray(qpos)))
  tenv._state = ts.replace(data=ts.data.replace(qpos=torch.as_tensor(qpos)))


def test_six_env_steps_match_jax(pair):
  """Observations, rewards, done flags, extras and every state leaf (the
  command's `motion/*` leaves and its bin statistics included) within
  1e-6 over the reset and six env-steps."""
  jenv, tenv = pair
  assert tenv.per_env_fields == ['body_ipos', 'geom_friction', 'qpos0']
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  assert tobs['policy'].shape == (N, 160) and tobs['critic'].shape == (N, 286)
  for g in ('policy', 'critic'):
    _close(tobs[g], jobs[g], f'reset obs {g}', 1e-12)
  leaves = lambda: (env_state_to_numpy(tenv.state, tenv),
                    env_state_leaves(jenv.state, tenv.per_env_fields))
  _same_tree(*leaves(), 'reset state')
  assert set(tenv.state.command['motion']) == set(
      jenv.state.command['motion'])
  view = tenv.scene['robot']
  qpos = fold_arm_qpos(np.asarray(jenv.state.data.qpos).copy(),
                       view.idx.joint_names, view.idx.q_adr, FOLD)
  _set_qpos(jenv, tenv, qpos)

  rng = np.random.default_rng(0)
  time_steps, self_contacts, fired = [], [], []
  for i in range(STEPS):
    act = 0.1 * rng.normal(size=(N, 29))
    if i == TIP_AT:
      tenv._state = tip_over_state(torch, tenv.state, 1, TRACK_TIP)
      _set_qpos(jenv, tenv, tenv.state.data.qpos.numpy())
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(torch.as_tensor(act))
    what = f'step {i}'
    for g in ('policy', 'critic'):
      _close(tout[0][g], jout[0][g], f'{what} obs {g}')
    for k, name in ((1, 'reward'), (2, 'terminated'), (3, 'truncated')):
      _close(tout[k], jout[k], f'{what} {name}')
    assert set(tout[4]) == set(jout[4]), what
    _same_tree(tout[4], jout[4], f'{what} extras')
    _same_tree(*leaves(), f'{what} state')
    if i == TIP_AT:
      assert float(tout[4]['Episode_Termination/anchor_ori']) == 1.0
    time_steps.append(tenv.state.command['motion']['time_steps'].tolist())
    self_contacts.append(tenv.state.data.sensordata[:, 0].tolist())
    fired.append(tout[2].tolist())
  # env 0 runs the clip of five frames and loops to its first frame
  assert [t[0] for t in time_steps] == [2, 3, 4, 0, 1, 2]
  # env 1, tipped, ends by anchor_ori and restarts at frame 0 (+1)
  assert fired[TIP_AT] == [False, True, False]
  assert time_steps[TIP_AT][1] == 1
  # env 2's folded arm is counted by the self-collision sensor
  assert self_contacts[0][FOLD] > 0 and self_contacts[0][0] == 0
