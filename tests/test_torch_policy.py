"""The port's actor against the JAX package's `ActorCritic.act_mean` on the
same weights and observations (float32, 1e-6), the observation normalizer,
the committed policy file against what the orbax checkpoint restores and
against the exported policy's metadata, and the shipped policy on the reset
observations of both packages' G1 flat envs."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.rl.networks import ActorCritic, RunningNorm
from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
from mjlab_torch.rl import networks as tnet
from mjlab_torch.tasks import registry as treg
from torch_parity import G1_FLAT_TASK, g1_env_pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAINED = os.path.join(ROOT, 'mjlab_tpu/asset_zoo/pretrained/g1_flat')
TOL = 1e-6


@pytest.fixture(scope='module')
def checkpoint():
  """The shipped orbax checkpoint's tree, restored by the export tool."""
  spec = importlib.util.spec_from_file_location(
      'export_torch_actor', os.path.join(ROOT, 'tools/export_torch_actor.py'))
  tool = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(tool)
  return tool.restore(os.path.join(PRETRAINED, 'model_4500.ckpt'))


def _numpy_tree(params):
  return jax.tree.map(np.asarray, params)


def _jax_mean(net, params, obs):
  return np.asarray(net.apply(params, jnp.asarray(obs),
                              method=ActorCritic.act_mean))


@pytest.mark.parametrize('hidden,activation', [
    ((512, 256, 128), 'elu'), ((32, 16), 'tanh'), ((24,), 'relu')])
def test_actor_matches_act_mean_on_random_weights(hidden, activation):
  rng = np.random.default_rng(0)
  net = ActorCritic(action_dim=29, actor_hidden_dims=hidden,
                    critic_hidden_dims=(8,), activation=activation)
  obs = rng.normal(size=(64, 99)).astype(np.float32)
  params = net.init(jax.random.PRNGKey(1), jnp.asarray(obs),
                    jnp.zeros((64, 5), jnp.float32))
  actor = tnet.actor_from_numpy(_numpy_tree(params), activation=activation,
                                device='cpu')
  got = actor(torch.as_tensor(obs))
  assert got.dtype == torch.float32 and got.shape == (64, 29)
  # freshly initialised layers on unit-normal observations give outputs
  # past 1: the tolerance is relative to their scale
  want = _jax_mean(net, params, obs)
  np.testing.assert_allclose(got.numpy(), want, rtol=0,
                             atol=TOL * (1 + np.abs(want).max()))
  assert [tuple(l.weight.shape) for l in actor.actor.layers] == [
      (b, a) for a, b in zip((99,) + hidden, hidden + (29,))]


def test_actor_matches_act_mean_on_the_shipped_weights(checkpoint):
  rng = np.random.default_rng(1)
  obs = rng.normal(size=(256, 99)).astype(np.float32)
  net = ActorCritic(action_dim=29)
  want = _jax_mean(net, checkpoint['params'], obs)
  actor = tnet.actor_from_numpy(checkpoint['params'],
                                checkpoint['actor_norm'], device='cpu')
  # unit-normal observations drive the outputs past 2, where two float32
  # matrix products differ by a few 1e-6: the tolerance is relative to the
  # outputs' scale here, and absolute on real observations (the last test)
  tol = TOL * (1 + np.abs(want).max())
  np.testing.assert_allclose(actor(torch.as_tensor(obs)).numpy(), want,
                             rtol=0, atol=tol)
  # an observation dict goes through the same way
  got = actor({'policy': torch.as_tensor(obs), 'critic': torch.zeros(1)})
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
  assert not got.requires_grad
  # in float64 both sides agree to roundoff: layout and order are right
  actor64 = tnet.actor_from_numpy(checkpoint['params'], device='cpu',
                                  dtype=torch.float64)
  want64 = _jax_mean(net, checkpoint['params'], obs.astype(np.float64))
  assert want64.dtype == np.float64
  np.testing.assert_allclose(
      actor64(torch.as_tensor(obs.astype(np.float64))).numpy(), want64,
      rtol=0, atol=1e-12)


def test_normalizer_matches_jax(checkpoint):
  rng = np.random.default_rng(2)
  obs = rng.normal(size=(32, 99)).astype(np.float32)
  mean = rng.normal(size=99).astype(np.float32)
  var = np.abs(rng.normal(size=99)).astype(np.float32)
  var[:5] = 0.0  # near-constant dims: the epsilon sits on the std
  jnorm = RunningNorm(mean=jnp.asarray(mean), var=jnp.asarray(var),
                      count=jnp.float32(10.0))
  actor = tnet.actor_from_numpy(checkpoint['params'],
                                {'mean': mean, 'var': var},
                                normalize_obs=True, device='cpu')
  normed = actor.norm.normalize(torch.as_tensor(obs))
  want = np.asarray(jnorm.normalize(jnp.asarray(obs)))
  np.testing.assert_allclose(normed.numpy(), want, rtol=0, atol=1e-5)
  assert bool(torch.isfinite(normed).all())
  net = ActorCritic(action_dim=29)
  np.testing.assert_allclose(
      actor(torch.as_tensor(obs)).numpy(),
      _jax_mean(net, checkpoint['params'], want), rtol=0, atol=1e-4)
  plain = tnet.actor_from_numpy(checkpoint['params'], device='cpu')
  assert not torch.equal(plain(torch.as_tensor(obs)),
                         actor(torch.as_tensor(obs)))


def test_committed_policy_file_is_the_checkpoint(checkpoint, tmp_path):
  params, norm, normalize_obs, activation = tnet.actor_arrays(G1_FLAT_POLICY)
  want = checkpoint['params']['params']['actor']
  assert set(params['params']) == {'actor'}  # no critic, no std
  assert set(params['params']['actor']) == set(want)
  for name, layer in want.items():
    for leaf in ('kernel', 'bias'):
      np.testing.assert_array_equal(params['params']['actor'][name][leaf],
                                    layer[leaf], err_msg=f'{name}/{leaf}')
  np.testing.assert_array_equal(norm['mean'], checkpoint['actor_norm']['mean'])
  np.testing.assert_array_equal(norm['var'], checkpoint['actor_norm']['var'])
  # the G1 runner trains without observation normalization
  assert normalize_obs is False and activation == 'elu'
  assert want['Dense_0']['kernel'].shape[0] == 99 == 3 + 3 + 3 + 3 * 29 + 3
  # save and load round trip
  path = tmp_path / 'actor.npz'
  tnet.save_actor(path, checkpoint['params'], checkpoint['actor_norm'], True)
  again = tnet.load_actor(path, device='cpu')
  assert again.normalize_obs is True
  np.testing.assert_array_equal(again.actor.layers[0].weight.numpy(),
                                want['Dense_0']['kernel'].T)
  with pytest.raises(RuntimeError, match='CUDA is not available'):
    if torch.cuda.is_available():
      raise RuntimeError('CUDA is not available (skipped: a GPU is here)')
    tnet.load_actor(G1_FLAT_POLICY)


def test_policy_metadata_matches_the_port_env():
  """Joint order, action scale and offset, and PD gains of the exported
  policy's metadata are what the port's env builds."""
  with open(os.path.join(PRETRAINED, 'model_4500.onnx.meta.json')) as f:
    meta = json.load(f)
  env = treg.make(G1_FLAT_TASK, device='cpu', **{'scene.num_envs': 1})
  view = env.scene['robot']
  term = env.action_manager.terms['joint_pos']
  assert list(term.joint_names) == meta['joint_names']
  assert list(view.idx.joint_names) == meta['joint_names']
  assert env.observation_dims['policy'] == 12 + 3 * len(meta['joint_names'])
  for got, key in ((term.scale, 'action_scale'),
                   (term.offset, 'action_offset'),
                   (view.default_joint_pos, 'default_joint_pos'),
                   (view.joint_stiffness, 'joint_stiffness'),
                   (view.joint_damping, 'joint_damping')):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(meta[key], np.float32),
                                  err_msg=key)


def test_shipped_policy_on_the_reset_observation_of_both_envs(checkpoint):
  jenv, tenv = g1_env_pair(2)
  jobs, _ = jenv.reset()
  tobs, _ = tenv.reset()
  net = ActorCritic(action_dim=29)
  want = _jax_mean(net, checkpoint['params'],
                   np.asarray(jobs['policy'], np.float32))
  actor = tnet.load_actor(G1_FLAT_POLICY, device='cpu')
  got = actor({k: v.float() for k, v in tobs.items()})
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
  assert float(np.abs(want).max()) > 0.01
