"""The port's G1 flat velocity environment alone, on the CPU from the
committed scene snapshot: one host sync a step, state carried across as
numpy, no write into a kept state, the blow-up guard, the distributions of
the registered configuration's draws, and the default device. The parity
with the JAX package's env is in test_torch_env.py."""

import re

import numpy as np
import pytest
import torch

from chip_smoke import degenerate_ranges
from mjlab_torch.envs.io import env_state_from_numpy, env_state_to_numpy
from mjlab_torch.tasks import registry as treg
from torch_parity import G1_FLAT_TASK

N = 2


@pytest.fixture(scope='module')
def tenv():
  """The degenerate-range G1 flat env (every sampling range collapsed to a
  point), float64."""
  return treg.make(G1_FLAT_TASK,
                   cfg=degenerate_ranges(treg.load_cfg(G1_FLAT_TASK), N),
                   device='cpu', dtype=torch.float64)


def test_state_round_trip_and_no_aliasing(tenv):
  tenv.reset()
  tenv.step(torch.full((N, 29), 0.1, dtype=torch.float64))
  state = tenv.state
  leaves = env_state_to_numpy(state, tenv)
  back = env_state_from_numpy(leaves, tenv)
  again = env_state_to_numpy(back, tenv)

  def same(a, b, path=''):
    assert set(a) == set(b), path
    for k in a:
      if isinstance(a[k], dict):
        same(a[k], b[k], f'{path}/{k}')
      else:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f'{path}/{k}')
        assert a[k].dtype == b[k].dtype, f'{path}/{k}'

  same(leaves, again)
  assert back.data.qpos.data_ptr() != state.data.qpos.data_ptr()
  assert back.model.geom_friction.data_ptr() != \
      tenv._template_state.model.geom_friction.data_ptr()
  assert back.episode_length.dtype == torch.int32

  # the restored state steps as the original does
  act = torch.full((N, 29), -0.2, dtype=torch.float64)
  s1, out1 = tenv.step_fn(state, act)
  s2, out2 = tenv.step_fn(back, act)
  assert torch.equal(out1[0]['policy'], out2[0]['policy'])
  assert torch.equal(s1.data.qpos, s2.data.qpos)

  # nothing wrote into the states that were kept: the stepped-from state,
  # the template, the model's qpos0
  same(leaves, env_state_to_numpy(state, tenv))
  template = tenv._template_state
  assert torch.equal(template.data.qpos,
                     tenv.model.qpos0.expand(N, -1))
  assert int(template.common_step) == 0
  assert float(template.actions.abs().max()) == 0.0
  np.testing.assert_array_equal(
      tenv.model.qpos0.numpy(), np.asarray(tenv.scene.mj_model.qpos0))


def test_step_reads_one_device_value_on_the_host(tenv, monkeypatch):
  """`bool(done.any())` of the conditional refresh is the step's only
  read of a tensor's value on the host: no .item(), .nonzero(), .cpu(),
  .tolist() or .numpy(), and one bool()."""
  tenv.reset()
  act = torch.zeros(N, 29, dtype=torch.float64)
  tenv.step(act)  # first use fills the index-table cache
  calls = []
  for name in ('__bool__', 'item', 'nonzero', 'cpu', 'tolist', 'numpy',
               '__int__', '__float__', '__index__'):
    orig = getattr(torch.Tensor, name)

    def counted(self, *a, _orig=orig, _name=name, **kw):
      calls.append(_name)
      return _orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, name, counted)
  masked_index = []
  orig_getitem = torch.Tensor.__getitem__

  def getitem(self, idx):
    parts = idx if isinstance(idx, tuple) else (idx,)
    if any(torch.is_tensor(p) and p.dtype == torch.bool for p in parts):
      masked_index.append(idx)
    return orig_getitem(self, idx)

  monkeypatch.setattr(torch.Tensor, '__getitem__', getitem)
  # a tensor made from host data inside the step would be a copy to the
  # device, and a wait for it, on every step
  uploads = []
  for name in ('tensor', 'as_tensor', 'from_numpy'):
    orig = getattr(torch, name)

    def made(data, *a, _orig=orig, _name=name, **kw):
      if not torch.is_tensor(data):
        uploads.append((_name, data))
      return _orig(data, *a, **kw)

    monkeypatch.setattr(torch, name, made)
  tenv.step(act)
  monkeypatch.undo()
  assert calls == ['__bool__'], calls
  assert not masked_index
  assert not uploads, uploads


@pytest.mark.parametrize('fault', ['nan', 'inf', 'fast'])
def test_blowup_guard(tenv, fault):
  """An env whose state goes non-finite, or whose |qvel| passes
  sanity_qvel_limit, is terminated and reset, earns no reward, and poisons
  neither its own observation nor its neighbour."""
  tenv.reset()
  state = tenv.state
  qvel = state.data.qvel.clone()
  qvel[0, 8] = {'nan': float('nan'), 'inf': float('inf'), 'fast': 1e4}[fault]
  state = state.replace(data=state.data.replace(qvel=qvel))
  new, (obs, reward, terminated, truncated, extras) = tenv.step_fn(
      state, torch.zeros(N, 29, dtype=torch.float64))
  assert terminated.tolist() == [True, False]
  assert truncated.tolist() == [False, False]
  assert float(reward[0]) == 0.0 and float(reward[1]) != 0.0
  assert int(extras['Episode_Termination/physics_nan']) == 1
  assert float(extras['reset_count']) == 1.0
  for leaf in (obs['policy'], obs['critic'], new.data.qpos, new.data.qvel,
               new.data.qacc, new.data.xpos, new.data.cvel):
    assert bool(torch.isfinite(leaf).all())
  assert int(new.episode_length[0]) == 0 and int(new.episode_length[1]) == 1
  assert float(new.data.qvel[0].abs().max()) < 1.0


def test_registered_configuration_draws(monkeypatch):
  """The registered (non-degenerate) configuration on the port alone, 512
  envs, float32: every draw lies in its range and fills it, from the env's
  seeded generator; and the entry point wants the GPU unless asked for the
  CPU."""
  n = 512
  with monkeypatch.context() as mp:
    mp.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
      treg.make(G1_FLAT_TASK, **{'scene.num_envs': 2})
  env = treg.make(G1_FLAT_TASK, device='cpu', **{'scene.num_envs': n})
  assert env.device.type == 'cpu' and env._gen.device.type == 'cpu'
  obs, _ = env.reset()
  st = env.state
  assert obs['policy'].shape == (n, 99) and obs['policy'].dtype == torch.float32
  assert bool(torch.isfinite(obs['policy']).all())

  fr = st.model.geom_friction
  view = env.scene['robot']
  base = env.scene.model.geom_friction
  foot = torch.zeros(base.shape[0], dtype=torch.bool)
  for i, name in enumerate(view.idx.geom_names):
    if re.match(r'^(left|right)_foot[1-7]_collision$', name):
      foot[view.idx.geom_ids[i]] = True
  assert int(foot.sum()) == 14
  f0 = fr[:, foot, 0]
  assert float(f0.min()) >= 0.3 and float(f0.max()) < 1.2
  assert abs(float(f0.mean()) - 0.75) < 0.02 and float(f0.std()) > 0.2
  assert torch.equal(fr[:, ~foot], base[~foot].expand(n, -1, -1))
  assert torch.equal(fr[:, foot, 1:], base[foot, 1:].expand(n, -1, -1))

  off = view.root_pos_w(st.data)[:, :2] - env.scene.env_origins[:, :2]
  assert float(off.abs().max()) <= 0.5 and float(off.std()) > 0.2
  assert abs(float(off.mean())) < 0.05
  origins = env.scene.env_origins
  xs = origins[:, 0].unique()  # a 23 x 23 grid at spacing 2, centred
  assert len(xs) == 23 and float(xs[-1] - xs[0]) == pytest.approx(44.0)
  assert float(origins.mean(0).abs().max()) < 1e-5

  tw = st.command['twist']
  moving = ~tw['is_standing']
  cmd = tw['command'][moving]
  assert float(cmd[:, 0].abs().max()) <= 1.0
  assert float(cmd[:, 1].abs().max()) <= 0.5
  assert float(cmd[:, 2].abs().max()) <= 1.0
  assert float(cmd[:, 0].std()) > 0.4 and float(cmd[:, 1].std()) > 0.2
  assert float(tw['command'][~moving].abs().max()) == 0.0
  standing = float(tw['is_standing'].float().mean())
  assert 0.05 < standing < 0.16, standing  # 0.1 of 512: sigma 0.013
  assert bool(tw['is_heading'].all())
  assert float(tw['heading_target'].abs().max()) <= np.pi
  assert 3.0 <= float(tw['time_left'].min()) and \
      float(tw['time_left'].max()) < 8.0
  push = st.event['push_robot/time_left']
  assert 1.0 <= float(push.min()) and float(push.max()) < 3.0
  assert float(push.std()) > 0.4

  # the same seed gives the same episode, another seed another one
  again, _ = env.reset()
  assert torch.equal(again['policy'], obs['policy'])
  other, _ = env.reset(seed=7)
  assert not torch.equal(other['policy'], obs['policy'])

  # observation noise is on for the policy group only
  diff = (obs['policy'] - obs['critic']).abs()
  assert float(diff[:, :3].max()) <= 0.1 + 1e-6 and float(diff[:, :3].std()) > 0.01
  assert float(diff[:, 67:].max()) == 0.0  # actions, command: no noise
