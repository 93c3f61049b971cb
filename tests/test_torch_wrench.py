"""The external-wrench path of the port against its references: the
joint-space force of `xfrc_applied` (`physics/smooth.py:xfrc_accumulate`)
and the smooth acceleration it feeds against MuJoCo, float64, 1e-9; and
the G1 flat env with a wrench on its torso every other env-step
(`apply_external_force_torque`, its ranges collapsed to a point, as
`chip_smoke.external_wrench` adds it) against the JAX env, both float64 on
one compiled model: reset and six env-steps within 1e-6 on observations,
rewards, done flags, extras and every leaf of the state, with env 1
tipped over so that a masked reset clears its wrench and only its."""

import mujoco
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mjlab_torch.physics as tphys
from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.physics import smooth as tsmooth
from test_physics_smooth import ARTICULATED_XML, _random_state
from torch_parity import env_state_leaves, jax_env_f64

N = 2
TOL = 1e-6  # 24 substeps of contact dynamics amplify float64 roundoff
STEPS = 6
TIP_AT = 2  # the env-step before which env 1 is tipped over
# chip_smoke.py phase 19b's points: a wrench every two env-steps (at
# env-steps 2, 4 and 6)
FORCE = cs.WRENCH_POINT['force_range']
TORQUE = cs.WRENCH_POINT['torque_range']


def _close(got, want, what, tol):
  got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  if want.dtype == bool:
    np.testing.assert_array_equal(got, want, err_msg=what)
  else:
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize('seed', [3, 4])
def test_xfrc_accumulate_matches_mujoco(seed):
  """A random wrench on every body of the articulated model (free, ball,
  hinge and slide joints) at a random state: xfrc_accumulate against
  MuJoCo's mj_applyFT at each body's CoM, and qacc_smooth against
  mj_forward's."""
  mj = mujoco.MjModel.from_xml_string(ARTICULATED_XML)
  md = mujoco.MjData(mj)
  qpos, qvel, _ = _random_state(mj, seed)
  rng = np.random.default_rng(seed + 10)
  xfrc = rng.uniform(-5, 5, (mj.nbody, 6))
  xfrc[0] = 0
  md.qpos[:], md.qvel[:], md.xfrc_applied[:] = qpos, qvel, xfrc
  mujoco.mj_forward(mj, md)
  want = np.zeros(mj.nv)
  for b in range(1, mj.nbody):
    mujoco.mj_applyFT(mj, md, xfrc[b, :3], xfrc[b, 3:], md.xipos[b], b,
                      want)

  m = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  d = tphys.make_batched_data(m, 1, device='cpu').replace(
      qpos=torch.as_tensor(qpos)[None], qvel=torch.as_tensor(qvel)[None],
      xfrc_applied=torch.as_tensor(xfrc)[None])
  d = tphys.pipeline.fwd_velocity(m, tphys.pipeline.fwd_position(m, d))
  got = tsmooth.xfrc_accumulate(m, d)
  _close(got[0], want, 'xfrc_accumulate', 1e-9)
  assert np.abs(want).max() > 1.0
  d = tsmooth.fwd_smooth(m, tsmooth.actuation(m, d))
  _close(d.qacc_smooth[0], md.qacc_smooth, 'qacc_smooth', 1e-9)


@pytest.fixture(scope='module')
def pair():
  """(JAX env, port env) of G1 flat with the torso wrench, both float64
  on one compiled model, every range a point."""
  from mjlab_tpu.envs import mdp as jmdp
  from mjlab_tpu.managers import term_cfg as jtc
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.envs import mdp as tmdp
  from mjlab_torch.managers import term_cfg as ttc
  from mjlab_torch.tasks import registry as treg

  def cfg(reg, mdp, tc):
    return cs.external_wrench(
        cs.degenerate_ranges(reg.load_cfg(cs.ENV_TASK), N), mdp, tc,
        **cs.WRENCH_POINT)

  jenv = jax_env_f64(cfg(jreg, jmdp, jtc), quick=True)
  tenv = treg.make(cs.ENV_TASK, cfg=cfg(treg, tmdp, ttc), device='cpu',
                   dtype=torch.float64, mj_model=jenv.scene.mj_model)
  return jenv, tenv


def _same_state(jenv, tenv, what):
  got = env_state_to_numpy(tenv.state, tenv)
  want = env_state_leaves(jenv.state)

  def walk(g, w, path):
    for k, v in g.items():
      if isinstance(v, dict):
        walk(v, w[k], f'{path}/{k}')
      else:
        _close(v, w[k], f'{path}/{k}', TOL)

  walk(got, want, what)


def _torso_wrench(env):
  view = env.scene['robot']
  body = int(view.idx.body_ids[view.idx.body_names.index(cs.WRENCH_BODY)])
  x = env.state.data.xfrc_applied
  return np.asarray(x[:, body].detach().numpy() if torch.is_tensor(x)
                    else x[:, body])


def test_six_wrenched_env_steps_match_jax(pair):
  import jax.numpy as jnp
  jenv, tenv = pair
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  for g in ('policy', 'critic'):
    _close(tobs[g], jobs[g], f'reset obs {g}', 1e-12)
  _same_state(jenv, tenv, 'reset state')
  assert not _torso_wrench(tenv).any()
  push = np.array([*FORCE[:1] * 3, *TORQUE[:1] * 3])
  rng = np.random.default_rng(0)
  fired = []
  for i in range(STEPS):
    act = 0.3 * rng.normal(size=(N, 29))
    if i == TIP_AT:
      qpos = np.asarray(jenv.state.data.qpos).copy()
      half = np.radians(80.0) / 2
      qpos[1, 3:7] = [np.cos(half), np.sin(half), 0.0, 0.0]
      js, ts = jenv.state, tenv.state
      jenv._state = js.replace(data=js.data.replace(qpos=jnp.asarray(qpos)))
      tenv._state = ts.replace(
          data=ts.data.replace(qpos=torch.as_tensor(qpos)))
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(torch.as_tensor(act))
    what = f'step {i}'
    for g in ('policy', 'critic'):
      _close(tout[0][g], jout[0][g], f'{what} obs {g}', TOL)
    _close(tout[1], jout[1], f'{what} reward', TOL)
    _close(tout[2], jout[2], f'{what} terminated', TOL)
    assert set(tout[4]) == set(jout[4]), what
    for k, v in tout[4].items():
      _close(v, jout[4][k], f'{what} extras {k}', TOL)
    _same_state(jenv, tenv, f'{what} state')
    fired.append(tout[2].tolist())
    w = _torso_wrench(tenv)
    if i % 2 == 1:  # the interval fired: every env carries the wrench
      assert np.array_equal(w, np.tile(push, (N, 1))), (what, w)
    elif i == TIP_AT:  # env 1 reset: its wrench cleared, env 0 keeps its
      assert np.array_equal(w[0], push) and not w[1].any(), (what, w)
  assert fired == [[False, i == TIP_AT] for i in range(STEPS)]
  assert int(tenv.state.common_step) == STEPS
