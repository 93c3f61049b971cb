"""The port's ONNX export (mjlab_torch/rl/{onnx_writer,exporter}.py)
against the JAX package's: the serialization byte for byte on the golden
fixture and on a motion graph, the exported graph against the port's actor
in float32 with and without observation normalization, the shipped G1
flat policy exported again against the shipped ONNX file, and the
reference's fault the port does not carry over (its graph of a policy
trained without normalization folds in the running statistics). The
runner's export on save, and its rule that a failed export does not stop
training."""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from mjlab_tpu.rl import onnx_writer as jwriter
from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
from mjlab_torch.rl import exporter as texporter
from mjlab_torch.rl import onnx_writer as twriter
from mjlab_torch.rl.networks import (
    ActorCritic,
    RunningNorm,
    actor_critic_from_numpy,
    load_actor,
)
from mjlab_torch.tasks import registry as treg
from torch_parity import G1_FLAT_TASK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'tests', 'data')
SHIPPED_ONNX = os.path.join(ROOT, 'mjlab_tpu/asset_zoo/pretrained/g1_flat/'
                            'model_4500.onnx')


def _golden_module():
  sys.path.insert(0, DATA)
  try:
    import make_golden_onnx
  finally:
    sys.path.remove(DATA)
  return make_golden_onnx


@pytest.fixture(scope='module')
def golden():
  """(the port's ActorCritic and RunningNorm holding the golden fixture's
  ramp parameters and normalizer, the flax tree as numpy, the metadata)."""
  mod = _golden_module()
  _, params = mod.deterministic_params()
  params = jax.tree.map(np.asarray, params)
  net = actor_critic_from_numpy(params, device='cpu')
  norm = RunningNorm(mod.OBS)
  with torch.no_grad():
    norm.mean.copy_(torch.as_tensor(np.linspace(-1, 1, mod.OBS)))
    norm.var.copy_(torch.as_tensor(np.linspace(0.5, 2.0, mod.OBS)))
  return net, norm, params, {'task': 'golden', 'dt': '0.02'}


def test_export_is_byte_equal_to_the_golden_fixture(golden, tmp_path):
  net, norm, _, meta = golden
  path = str(tmp_path / 'policy.onnx')
  texporter.export_policy_as_onnx(net, norm, None, path, normalize_obs=True,
                                  metadata=meta)
  with open(path, 'rb') as f, \
      open(os.path.join(DATA, 'golden_policy.onnx'), 'rb') as g:
    assert f.read() == g.read()
  with open(path + '.meta.json') as f, \
      open(os.path.join(DATA, 'golden_policy.onnx.meta.json')) as g:
    assert f.read() == g.read()


def test_motion_graph_bytes_match_the_reference_writer(golden, tmp_path):
  """write_motion_policy of both packages on the same arrays."""
  _, _, params, meta = golden
  tree = params['params']['actor']
  layers = [(np.asarray(tree[f'Dense_{i}']['kernel']),
             np.asarray(tree[f'Dense_{i}']['bias'])) for i in range(len(tree))]
  rng = np.random.default_rng(0)
  obs_dim = layers[0][0].shape[0]
  mean = rng.normal(size=obs_dim).astype(np.float32)
  std = rng.uniform(0.5, 2.0, obs_dim).astype(np.float32)
  motion = {'joint_pos': rng.normal(size=(7, 4)).astype(np.float32),
            'anchor_quat_w': rng.normal(size=(7, 4)).astype(np.float32)}
  out = []
  for writer in (jwriter, twriter):
    path = str(tmp_path / f'{writer.__name__}.onnx')
    writer.write_motion_policy(path, layers, mean, std, motion, 'elu', meta)
    with open(path, 'rb') as f:
      out.append(f.read())
  assert out[0] == out[1]
  parsed = twriter.parse_model(str(tmp_path / f'{twriter.__name__}.onnx'))
  assert parsed['inputs'] == ['obs', 'time_step']
  np.testing.assert_array_equal(parsed['initializers']['motion_joint_pos'],
                                motion['joint_pos'])


@pytest.mark.parametrize('normalize', [True, False])
def test_graph_computes_the_actor(normalize, tmp_path):
  """The exported graph evaluated in numpy against the port's actor in
  float32: layers of unequal widths, so the (out, in) weights must be
  written as (in, out) kernels, and a normalizer with non-trivial
  statistics, which the graph must fold in only when the policy uses
  it."""
  gen = torch.Generator().manual_seed(0)
  net = ActorCritic(11, 11, 5, (32, 24), (8,), generator=gen)
  norm = RunningNorm(11)
  norm.update(3.0 + 2.0 * torch.randn(300, 11, generator=gen))
  path = str(tmp_path / 'p.onnx')
  texporter.export_policy_as_onnx(net, norm, None, path,
                                  normalize_obs=normalize)
  parsed = twriter.parse_model(path)
  assert [n['op_type'] for n in parsed['nodes']] == [
      'Sub', 'Div', 'Gemm', 'Elu', 'Gemm', 'Elu', 'Gemm']
  assert parsed['initializers']['w0'].shape == (11, 32)
  obs = torch.randn(64, 11, generator=gen) * 2.0 + 3.0
  with torch.no_grad():
    want = net.act_mean(norm.normalize(obs) if normalize else obs).numpy()
  got = twriter.run_mlp_policy(parsed, obs.numpy())
  assert np.abs(got - want).max() <= 1e-6 * (1 + np.abs(want).max())
  if not normalize:
    np.testing.assert_array_equal(parsed['initializers']['obs_mean'], 0.0)
    np.testing.assert_array_equal(parsed['initializers']['obs_std'], 1.0)


def _jax_graph(parsed, x):
  """The JAX package's own evaluation of an exported graph
  (tests/test_export.py:_run_graph), as an independent check of
  run_mlp_policy."""
  from test_export import _run_graph
  return _run_graph(parsed, x)


@pytest.fixture(scope='module')
def shipped(tmp_path_factory):
  """(the shipped actor, the port's export of it with the G1 flat env's
  metadata, parsed, and its sidecar; the shipped ONNX file, parsed, and
  its sidecar)."""
  actor = load_actor(G1_FLAT_POLICY, device='cpu')
  env = treg.make(G1_FLAT_TASK, device='cpu', **{'scene.num_envs': 1})
  path = str(tmp_path_factory.mktemp('onnx') / 'model_4500.onnx')
  texporter.export_policy_as_onnx(actor, actor.norm, env, path,
                                  normalize_obs=actor.normalize_obs)
  with open(path + '.meta.json') as f, open(SHIPPED_ONNX + '.meta.json') as g:
    metas = json.load(f), json.load(g)
  return (actor, twriter.parse_model(path), metas[0],
          twriter.parse_model(SHIPPED_ONNX), metas[1])


def test_shipped_policy_exports_to_the_shipped_graph(shipped):
  """Every Gemm initializer and the node list equal the shipped file's;
  the metadata equals its sidecar and its metadata_props exactly (the
  port's env holds the values in float32, as the JAX env that wrote the
  file did); the normalizer is the identity, since the G1 policy trains
  without normalization."""
  actor, port, port_meta, ref, ref_meta = shipped
  assert actor.normalize_obs is False
  assert port['nodes'] == ref['nodes']
  assert (port['inputs'], port['outputs']) == (ref['inputs'], ref['outputs'])
  gemm = [k for k in ref['initializers'] if k[0] in 'wb']
  assert len(gemm) == 8
  for k in gemm:
    np.testing.assert_array_equal(port['initializers'][k],
                                  ref['initializers'][k], err_msg=k)
  np.testing.assert_array_equal(port['initializers']['obs_mean'], 0.0)
  np.testing.assert_array_equal(port['initializers']['obs_std'], 1.0)
  assert port_meta == ref_meta
  assert {k: json.loads(v) for k, v in port['metadata'].items()} == ref_meta


def test_shipped_graph_is_not_the_shipped_policy(shipped):
  """The reference's fault, pinned: its exporter folds the running
  statistics into the graph though the G1 policy trains without
  normalization, so the shipped file's actions differ from the policy's
  by more than 1.0 on 64 observations drawn from N(0, 0.25) (11.5,
  where the policy's own actions reach 4.95); the port's export computes
  the policy."""
  actor, port, _, ref, _ = shipped
  obs = np.random.default_rng(0).normal(0.0, 0.5, (64, 99)).astype(
      np.float32)
  with torch.no_grad():
    want = actor(torch.as_tensor(obs)).numpy()
  ref_out = twriter.run_mlp_policy(ref, obs)
  np.testing.assert_allclose(ref_out, _jax_graph(ref, obs), rtol=0,
                             atol=1e-5)
  assert np.abs(ref_out - want).max() > 1.0
  assert np.abs(twriter.run_mlp_policy(port, obs) - want).max() < 1e-5


def test_runner_save_exports_and_survives_a_failed_export(tmp_path, capsys,
                                                          monkeypatch):
  """Every save of the velocity runner writes model_{it}.onnx and its
  sidecar beside the checkpoint, computing the runner's inference policy
  with the action term's joints in its metadata; a failed export prints
  and the save (and training) goes on."""
  from mjlab_torch.rl.runner import make_runner
  env = treg.make(G1_FLAT_TASK, device='cpu', **{'scene.num_envs': 2})
  cfg = treg.load_cfg(G1_FLAT_TASK, 'rl_cfg_entry_point')
  cfg.device = 'cpu'
  cfg.policy.actor_hidden_dims, cfg.policy.critic_hidden_dims = (16, 16), (16,)
  runner = make_runner(env, cfg)
  path = str(tmp_path / 'model_0.pt')
  runner.save(path)
  parsed = twriter.parse_model(str(tmp_path / 'model_0.onnx'))
  with open(tmp_path / 'model_0.onnx.meta.json') as f:
    meta = json.load(f)
  term = env.action_manager.terms['joint_pos']
  assert meta['joint_names'] == list(term.joint_names)
  obs, _ = env.reset()
  want = runner.get_inference_policy()(obs).numpy()
  got = twriter.run_mlp_policy(parsed, obs['policy'].numpy())
  assert np.abs(got - want).max() <= 1e-6 * (1 + np.abs(want).max())

  def broken(*a, **kw):
    raise OSError('disk full')

  monkeypatch.setattr(texporter, 'export_policy_as_onnx', broken)
  runner.save(str(tmp_path / 'model_1.pt'))
  assert os.path.exists(tmp_path / 'model_1.pt')
  assert not os.path.exists(tmp_path / 'model_1.onnx')
  assert "[export] onnx export failed: OSError('disk full')" in \
      capsys.readouterr().out
