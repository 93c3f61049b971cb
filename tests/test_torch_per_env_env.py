"""The G1 velocity env in the shape of BASELINE config 5 (a policy
observation history of 5; foot friction, pelvis mass and joint damping
randomized at startup: chip_smoke.full_dr_history) in the port against the
JAX package's, both float64 on one compiled model, 4 envs, under the
degenerate-range configuration: reset, then six env-steps with the same
distinct per-env values of the three fields written into both envs'
models (a draw of either package's own would differ), within 1e-6 on
observations, rewards, done flags, extras and every leaf of the state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    DR_FIELDS,
    HISTORY,
    degenerate_ranges,
    distinct_dr_values,
    full_dr_history,
)
from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.ops import smooth_kernel as tsk
from torch_parity import env_state_leaves, jax_env_f64

ENV_TOL = 1e-6  # 24 substeps of contact dynamics amplify float64 roundoff


def _close(got, want, tol, what):
  got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
  want = np.asarray(want)
  assert got.shape == want.shape, (what, got.shape, want.shape)
  np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


ENV_N = 4
ENV_STEPS = 6


def _config5(reg, mdp, term_cfg):
  cfg = degenerate_ranges(reg.load_cfg('Mjlab-Velocity-Flat-Unitree-G1'),
                          ENV_N)
  return full_dr_history(cfg, mdp, term_cfg)


@pytest.fixture(scope='module')
def env_pair():
  from mjlab_tpu.envs import mdp as jmdp
  from mjlab_tpu.managers import term_cfg as jtc
  from mjlab_tpu.tasks import registry as jreg
  from mjlab_torch.envs import mdp as tmdp
  from mjlab_torch.managers import term_cfg as ttc
  from mjlab_torch.tasks import registry as treg
  jenv = jax_env_f64(_config5(jreg, jmdp, jtc))
  tenv = treg.make('Mjlab-Velocity-Flat-Unitree-G1',
                   cfg=_config5(treg, tmdp, ttc), device='cpu',
                   dtype=torch.float64, mj_model=jenv.scene.mj_model)
  return jenv, tenv


def _tree_close(got, want, path):
  for k, v in got.items():
    if isinstance(v, dict):
      _tree_close(v, want[k], f'{path}/{k}')
    elif np.asarray(want[k]).dtype == bool:
      np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                    err_msg=f'{path}/{k}')
    else:
      _close(torch.as_tensor(np.asarray(v, np.float64)),
             np.asarray(want[k], np.float64), ENV_TOL, f'{path}/{k}')


def test_config5_env_matches_jax(env_pair):
  jenv, tenv = env_pair
  assert tenv.per_env_fields == sorted(DR_FIELDS) == sorted(
      jenv.event_manager.domain_randomization_fields())
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  # history 5 on the policy group: five frames of the 99 wide terms
  assert tobs['policy'].shape == (ENV_N, HISTORY * 99)
  assert tobs['critic'].shape == (ENV_N, 99)
  for g in tobs:
    _close(tobs[g], jobs[g], 1e-12, f'reset obs {g}')
  # the same distinct per-env values in both envs' models
  values = distinct_dr_values(tenv.scene.model, ENV_N)
  js, ts = jenv.state, tenv.state
  jenv._state = js.replace(model=js.model.replace(
      **{f: jnp.asarray(v) for f, v in values.items()}))
  tenv._state = ts.replace(model=ts.model.replace(
      **{f: torch.as_tensor(v) for f, v in values.items()}))
  assert tsk.plan_of(tenv.state.model).env_batch == ENV_N  # bconst per env
  rng = np.random.default_rng(0)
  for i in range(ENV_STEPS):
    act = 0.3 * rng.normal(size=(ENV_N, 29))
    jout = jenv.step(jnp.asarray(act))
    tout = tenv.step(torch.as_tensor(act))
    what = f'step {i}'
    for g in tout[0]:
      _close(tout[0][g], jout[0][g], ENV_TOL, f'{what} obs {g}')
    _close(tout[1], jout[1], ENV_TOL, f'{what} reward')
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    _tree_close({k: v.numpy() for k, v in tout[4].items()}, jout[4],
                f'{what} extras')
    _tree_close(env_state_to_numpy(tenv.state, tenv),
                env_state_leaves(jenv.state, tenv.per_env_fields),
                f'{what} state')
  # every env's own values, and the history holds five distinct frames
  for f, v in values.items():
    _close(getattr(tenv.state.model, f), v, 0.0, f)
  frames = tout[0]['policy'].reshape(ENV_N, -1, 99)
  assert not torch.equal(frames[:, 0], frames[:, -1])


def test_config5_expands_the_randomized_fields(env_pair):
  _, tenv = env_pair
  m, base = tenv.model, tenv.scene.model
  assert tenv.per_env_fields == ['body_mass', 'dof_damping', 'geom_friction']
  for f in DR_FIELDS:
    assert getattr(m, f).shape == (ENV_N,) + getattr(base, f).shape, f
  pelvis = tenv.scene['robot'].idx.body_ids[
      list(tenv.scene['robot'].idx.body_names).index('pelvis')]
  ratio = m.body_mass[:, pelvis] / base.body_mass[pelvis]
  assert bool(((ratio >= 0.9) & (ratio <= 1.1)).all())
  others = torch.ones(base.body_mass.shape[0], dtype=torch.bool)
  others[pelvis] = False
  assert torch.equal(m.body_mass[:, others],
                     base.body_mass[others].expand(ENV_N, -1))
  # the G1's compiled damping is zero on every dof: config 5's scale by
  # [0.8, 1.2] leaves it there, in the reference as in the port
  assert bool(((m.dof_damping >= 0.8 * base.dof_damping)
               & (m.dof_damping <= 1.2 * base.dof_damping)).all())
  feet = m.geom_friction[:, :, 0] != base.geom_friction[:, 0]
  f = m.geom_friction[:, :, 0][feet]
  assert int(feet[0].sum()) == 14 and bool(((f >= 0.3) & (f <= 1.2)).all())
