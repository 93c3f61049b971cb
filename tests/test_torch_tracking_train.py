"""Training, export and play of the G1 motion-tracking task in the port:
make_runner's choice, the motion-baked ONNX every save writes (read back
with onnx_writer.run_motion_policy against the policy and the clip), the
shipped tracking policy (its .npz against the orbax checkpoint, and its
export on the walk clip against the shipped ONNX, byte for byte), a tiny
train / resume / play on the CPU, and one learn iteration with observation
normalization on against the JAX learner (the toy env of
tests/test_torch_rl.py)."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_rl as rl_parity
from chip_smoke import TRACK_TASK
from mjlab_torch.asset_zoo.pretrained import (
    G1_TRACKING_MOTION,
    G1_TRACKING_POLICY,
)
from mjlab_torch.rl import exporter as texporter
from mjlab_torch.rl import networks as tnet
from mjlab_torch.rl import onnx_writer as twriter
from mjlab_torch.rl import ppo as tppo_mod
from mjlab_torch.rl.runner import (
    MotionTrackingOnPolicyRunner,
    VelocityOnPolicyRunner,
    make_runner,
)
from mjlab_torch.scripts import play, train
from mjlab_torch.tasks import registry as treg
from mjlab_tpu.rl import ppo as jppo_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = os.path.join(ROOT, 'mjlab_tpu/asset_zoo/pretrained/g1_tracking')
SMALL = ['--agent.num_steps_per_env', '2',
         '--agent.policy.actor_hidden_dims', '(16, 16)',
         '--agent.policy.critic_hidden_dims', '(16,)']
CLIP = ['--env.commands.motion.motion_file', str(G1_TRACKING_MOTION)]


def _env(n=2):
  return treg.make(TRACK_TASK, device='cpu', **{
      'scene.num_envs': n, 'commands.motion.motion_file':
      str(G1_TRACKING_MOTION)})


def _small_cfg():
  cfg = treg.load_cfg(TRACK_TASK, 'rl_cfg_entry_point')
  cfg.device = 'cpu'
  cfg.policy.actor_hidden_dims, cfg.policy.critic_hidden_dims = (16, 16), (16,)
  return cfg


def test_make_runner_picks_the_tracking_runner():
  """The tracking env gets the tracking runner, with normalization on for
  actor and critic; the velocity env keeps the velocity runner."""
  cfg = _small_cfg()
  assert cfg.policy.actor_obs_normalization
  assert cfg.policy.critic_obs_normalization
  assert type(make_runner(_env(), cfg)) is MotionTrackingOnPolicyRunner
  venv = treg.make('Mjlab-Velocity-Flat-Unitree-G1', device='cpu',
                   **{'scene.num_envs': 2})
  assert type(make_runner(venv, cfg)) is VelocityOnPolicyRunner


def test_save_writes_the_motion_onnx(tmp_path, capsys, monkeypatch):
  """Every save writes model_{it}.onnx and its sidecar: the actions of the
  graph (normalizer folded in) within 1e-6 of the inference policy after
  an update of the normalizer, its motion outputs the clip's rows at
  time_step 0, 17, T - 1 and T + 5 (clipped to T - 1); a failed export
  prints and the save goes on."""
  env = _env()
  runner = make_runner(env, _small_cfg())
  ts = runner.ts
  obs = ts.obs
  alg = runner.alg
  a_obs = alg._cat_obs(obs, alg.actor_groups)
  ts.actor_norm.update(3.0 * a_obs + 1.0)  # statistics away from (0, 1)
  path = str(tmp_path / 'model_0.pt')
  runner.save(path)
  parsed = twriter.parse_model(str(tmp_path / 'model_0.onnx'))
  with open(tmp_path / 'model_0.onnx.meta.json') as f:
    meta = json.load(f)
  assert meta['joint_names'] == list(
      env.action_manager.terms['joint_pos'].joint_names)
  np.testing.assert_array_equal(parsed['initializers']['obs_mean'],
                                ts.actor_norm.mean.numpy())
  np.testing.assert_array_equal(parsed['initializers']['obs_std'],
                                np.sqrt(ts.actor_norm.var.numpy()) + 1e-2)
  motion = env.command_manager.terms['motion'].motion
  T = motion.time_step_total
  steps = np.array([0, 17, T - 1, T + 5])
  out = twriter.run_motion_policy(parsed, a_obs[:1].expand(4, -1).numpy(),
                                  steps)
  want = runner.get_inference_policy()(obs).numpy()
  assert np.abs(out['actions'] - want[0]).max() <= 1e-6 * (
      1 + np.abs(want).max())
  rows = np.minimum(steps, T - 1)
  np.testing.assert_array_equal(out['joint_pos'], motion.joint_pos[rows])
  np.testing.assert_array_equal(out['joint_vel'], motion.joint_vel[rows])
  np.testing.assert_array_equal(out['anchor_pos_w'],
                                motion.body_pos_w[rows, 0])
  np.testing.assert_array_equal(out['anchor_quat_w'],
                                motion.body_quat_w[rows, 0])
  assert json.loads(parsed['metadata']['motion_frames']) == T

  def broken(*a, **kw):
    raise OSError('disk full')

  monkeypatch.setattr(texporter, 'export_motion_policy_as_onnx', broken)
  runner.save(str(tmp_path / 'model_1.pt'))
  assert os.path.exists(tmp_path / 'model_1.pt')
  assert not os.path.exists(tmp_path / 'model_1.onnx')
  assert "[export] onnx export failed: OSError('disk full')" in \
      capsys.readouterr().out


def _restore_checkpoint():
  spec = importlib.util.spec_from_file_location(
      'export_torch_actor', os.path.join(ROOT, 'tools/export_torch_actor.py'))
  tool = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(tool)
  return tool.restore(os.path.join(SHIPPED, 'model_6000.ckpt'))


def test_shipped_npz_is_the_checkpoint():
  """The committed tracking actor is the orbax checkpoint's actor and actor
  normalizer, with normalization on; 160 observations, 29 actions."""
  ckpt = _restore_checkpoint()
  params, norm, normalize_obs, activation = tnet.actor_arrays(
      G1_TRACKING_POLICY)
  want = ckpt['params']['params']['actor']
  assert set(params['params']['actor']) == set(want)
  for name, layer in want.items():
    for leaf in ('kernel', 'bias'):
      np.testing.assert_array_equal(params['params']['actor'][name][leaf],
                                    layer[leaf], err_msg=f'{name}/{leaf}')
  for k in ('mean', 'var'):
    np.testing.assert_array_equal(norm[k], ckpt['actor_norm'][k])
  assert normalize_obs is True and activation == 'elu'
  assert want['Dense_0']['kernel'].shape[0] == 160 == 5 * 29 + 15
  assert want[f'Dense_{len(want) - 1}']['kernel'].shape[1] == 29


def test_shipped_policy_exports_to_the_shipped_graph(tmp_path):
  """The port's export of the shipped actor on the walk clip is the
  shipped model_6000.onnx byte for byte: the same nodes, initializers
  (normalizer, weights, the baked clip) and metadata."""
  env = _env()
  actor = tnet.load_actor(G1_TRACKING_POLICY, device='cpu')
  path = str(tmp_path / 'port.onnx')
  texporter.export_motion_policy_as_onnx(
      actor, actor.norm, env, env.command_manager.terms['motion'].motion,
      path, normalize_obs=True)
  ref_path = os.path.join(SHIPPED, 'model_6000.onnx')
  port, ref = twriter.parse_model(path), twriter.parse_model(ref_path)
  assert port['nodes'] == ref['nodes']
  assert (port['inputs'], port['outputs']) == (ref['inputs'], ref['outputs'])
  assert sorted(port['initializers']) == sorted(ref['initializers'])
  for k, v in ref['initializers'].items():
    np.testing.assert_allclose(port['initializers'][k], v, rtol=0,
                               atol=1e-6, err_msg=k)
  with open(path, 'rb') as a, open(ref_path, 'rb') as b:
    assert a.read() == b.read()
  with open(path + '.meta.json') as a, open(ref_path + '.meta.json') as b:
    assert json.load(a) == json.load(b)


def test_train_resume_and_play_on_cpu(tmp_path):
  """train.main of the tracking task (2 envs, tiny widths) writes the
  checkpoint and its motion ONNX, a resumed run numbers on from it, and
  play plays the checkpoint and the shipped policy on its clip."""
  base = [TRACK_TASK, '--device', 'cpu', '--log-root', str(tmp_path),
          '--env.scene.num_envs', '2', '--agent.max_iterations', '1']
  runner = train.main(base + ['--run-name', 'a'] + SMALL + CLIP)
  assert type(runner) is MotionTrackingOnPolicyRunner
  run = tmp_path / 'g1_tracking'
  assert (run / 'a' / 'model_1.pt').exists()
  assert (run / 'a' / 'model_1.onnx').exists()
  with open(run / 'a' / 'metrics.jsonl') as f:
    logs = [json.loads(line) for line in f]
  assert np.isfinite(logs[-1]['loss'])
  again = train.main(base + ['--run-name', 'b', '--resume'] + SMALL + CLIP)
  assert again.ts.iteration == 2
  assert (run / 'b' / 'model_2.onnx').exists()
  stats = play.main([TRACK_TASK, '--device', 'cpu', '--log-root',
                     str(tmp_path), '--num-envs', '2', '--steps', '2']
                    + SMALL + CLIP)
  assert np.isfinite(stats['mean_reward'])
  assert set(stats['terminations']) >= {'anchor_pos', 'anchor_ori',
                                        'ee_body_pos', 'time_out'}
  shipped = play.main([TRACK_TASK + '-Play', '--device', 'cpu',
                       '--log-root', str(tmp_path / 'none'), '--num-envs',
                       '2', '--steps', '2'])
  assert shipped['motion_file'] == str(G1_TRACKING_MOTION)
  assert np.isfinite(shipped['metrics']['motion/error_body_pos'])


def test_learn_iteration_with_normalization_matches_jax():
  """One learn iteration of the toy env with observation normalization on
  for actor and critic, as the tracking runner trains: the rollout's
  buffers, advantages, logs and the learner state (both normalizers
  included) as tests/test_torch_rl.py holds them with normalization off."""
  jcfg, tcfg = rl_parity._cfgs()
  for cfg in (jcfg, tcfg):
    cfg.policy.actor_obs_normalization = True
    cfg.policy.critic_obs_normalization = True
  jppo = jppo_mod.PPO(rl_parity.JaxToyEnv(), jcfg)
  tppo = tppo_mod.PPO(rl_parity.TorchToyEnv(), tcfg)
  jts = jppo.init_state(0)
  tts = rl_parity._carried(jppo, tppo, jts)
  jr = jax.device_get(jax.jit(jppo._rollout)(jts))
  jtraj = jr[3]
  jts, jlogs = jppo.learn_iteration(jts)
  jlogs = jax.device_get(jlogs)
  tts, tlogs = tppo.learn_iteration(tts)
  tlogs.pop('_clock')
  traj = tppo.storage
  for k in ('actor_obs', 'critic_obs'):
    rl_parity._close(getattr(traj, k), getattr(jtraj, k), 1e-6, k)
  for k in ('done', 'time_out'):
    np.testing.assert_array_equal(getattr(traj, k).numpy(),
                                  np.asarray(getattr(jtraj, k)), err_msg=k)
  for k in ('logprob', 'mean', 'value', 'reward'):
    rl_parity._close(getattr(traj, k), getattr(jtraj, k), 1e-6, k)
  assert float(tts.actor_norm.count) > 1.0
  assert float((tts.actor_norm.mean - 0).abs().max()) > 1e-3
  for k in tlogs:
    if k in jlogs:
      rl_parity._close(tlogs[k], jlogs[k], 1e-5, f'log {k}')
  rl_parity._check_learner(tts, jts, 'normalized', 2,
                           tppo.cfg.algorithm.learning_rate)
