"""The port's G1 flat velocity environment against the JAX package's, both
float64 on one compiled model, under the degenerate-range configuration
(every sampling range collapsed to a point, so no output depends on a
random draw while resets, command resampling, pushes and observation noise
all run): reset, then six env-steps (24 substeps) with fixed actions, one
env tipped past `limit_angle` so that a masked reset and the whole-batch
refresh happen, within 1e-6 on observations, rewards, done flags, extras
and every leaf of the state. The tests of the port alone are in
test_torch_env_port.py, a file of its own so that another worker runs
them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.ops import smooth_kernel as tsk
from torch_parity import env_state_leaves, g1_env_pair

N = 2
TOL = 1e-6  # 24 substeps of contact dynamics amplify float64 roundoff
STEPS = 6
TIP_AT = 2  # the env-step before which env 1 is tipped over


@pytest.fixture(scope='module')
def pair():
  return g1_env_pair(N)


def _np(x):
  return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, what, tol=TOL):
  got, want = _np(got), _np(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0, atol=tol,
                               err_msg=what)


def _same_tree(got, want, path, tol=TOL):
  """Every leaf of `got` (the port's) against the JAX package's."""
  for k, v in got.items():
    if isinstance(v, dict):
      _same_tree(v, want[k], f'{path}/{k}', tol)
    else:
      _close(v, want[k], f'{path}/{k}', tol)


def _same_state(jenv, tenv, what):
  got = env_state_to_numpy(tenv.state, tenv)
  want = env_state_leaves(jenv.state)
  for k in ('command', 'obs', 'event', 'curriculum', 'reward'):
    assert set(got[k]) == set(want[k]), (what, k)
  _same_tree(got, want, what)


def _tip(quat_env1):
  """Env 1's root quaternion turned 80 degrees about x: past the 70 degree
  `limit_angle` of `fell_over`."""
  half = np.radians(80.0) / 2
  quat_env1[:] = [np.cos(half), np.sin(half), 0.0, 0.0]


def test_reset_and_six_steps_match_jax(pair, monkeypatch):
  jenv, tenv = pair
  plans = []
  init = tsk._Plan.__init__
  monkeypatch.setattr(tsk._Plan, '__init__',
                      lambda self, m: (plans.append(m), init(self, m))[1])

  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  for g in ('policy', 'critic'):
    _close(tobs[g], jobs[g], f'reset obs {g}', 1e-12)
    assert tobs[g].shape == (N, 99)
  _same_state(jenv, tenv, 'reset state')
  # the reset moved and turned the root, and set the friction point
  view = tenv.scene['robot']
  xy = view.root_pos_w(tenv.state.data)[:, :2] - tenv.scene.env_origins[:, :2]
  _close(xy, np.tile([0.3, -0.2], (N, 1)), 'root offset', 1e-12)
  feet = tenv.state.model.geom_friction[:, :, 0] == 0.45
  assert int(feet.sum()) == N * 14

  plan = tsk.plan_of(tenv.state.model)
  rng = np.random.default_rng(0)
  fired = []
  for i in range(STEPS):
    act = 0.3 * rng.normal(size=(N, 29))
    if i == TIP_AT:
      qpos = np.asarray(jenv.state.data.qpos).copy()
      _tip(qpos[1, 3:7])
      js, ts = jenv.state, tenv.state
      jenv._state = js.replace(data=js.data.replace(qpos=jnp.asarray(qpos)))
      tenv._state = ts.replace(
          data=ts.data.replace(qpos=torch.as_tensor(qpos)))
    pre_qpos = tenv.state.data.qpos
    pre_copy = pre_qpos.clone()
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(torch.as_tensor(act))
    assert torch.equal(pre_qpos, pre_copy), 'the pre-step state was written'
    what = f'step {i}'
    for g in ('policy', 'critic'):
      _close(tout[0][g], jout[0][g], f'{what} obs {g}')
    _close(tout[1], jout[1], f'{what} reward')
    _close(tout[2], jout[2], f'{what} terminated')
    _close(tout[3], jout[3], f'{what} truncated')
    assert set(tout[4]) == set(jout[4]), what
    _same_tree(tout[4], jout[4], f'{what} extras')
    _same_state(jenv, tenv, f'{what} state')
    fired.append(tout[2].tolist())
    if i == TIP_AT:
      # the masked reset put env 1 back on its origin and left env 0 alone
      assert float(tout[4]['reset_count']) == 1.0
      assert float(tout[4]['Episode_Termination/fell_over']) == 1.0
      assert tenv.state.episode_length.tolist() == [TIP_AT + 1, 0]
      assert float(tenv.state.data.qpos[1, 2]) > 0.7
  assert fired == [[False, i == TIP_AT] for i in range(STEPS)]
  # the command resampled (0.1 s clock), the push fired (0.06 s clock)
  assert float(tenv.state.command['twist']['command'][0, 0]) == 0.6
  assert int(tenv.state.common_step) == STEPS

  # four more steps of the port: ten in all on one launch plan of the
  # fused smooth stage (no step replaces or writes one of its Model tensors)
  for _ in range(4):
    tenv.step(torch.zeros(N, 29, dtype=torch.float64))
  assert tsk.plan_of(tenv.state.model) is plan
  assert len(plans) == 1
  assert tenv.state.model is tenv.model
