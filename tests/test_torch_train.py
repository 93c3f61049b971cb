"""The port's training path alone, on the CPU: PPO learns a contextual toy
task, a runner checkpoint round trip (with and without the env's state) on
the G1 flat env, `scripts/train.py` and `scripts/play.py` end to end, the
flags that are not ported yet, make_runner's choice of runner, and the
rollout's reads of device values on the host. The parity with the JAX learner is in test_torch_rl.py."""

import json
import os

import numpy as np
import pytest
import torch

from mjlab_torch.envs.io import env_state_to_numpy
from mjlab_torch.rl.config import RslRlOnPolicyRunnerCfg
from mjlab_torch.rl.ppo import PPO
from mjlab_torch.rl.runner import OnPolicyRunner, make_runner
from mjlab_torch.scripts import play, train
from mjlab_torch.tasks import registry
from torch_parity import G1_FLAT_TASK

SMALL = ['--agent.policy.actor_hidden_dims', '(16, 16)',
         '--agent.policy.critic_hidden_dims', '(16,)']


class FakeEnv:
  """The contextual regression task of tests/test_rl.py: obs in R^4, the
  optimal action the first 2 obs components, reward -|a - target|^2,
  episodes truncated every 8 steps."""

  num_envs = 16
  action_dim = 2
  observation_dims = {'policy': 4, 'critic': 4}
  step_dt = 0.02
  device = torch.device('cpu')

  def __init__(self):
    self.gen = torch.Generator()

  def _obs(self):
    x = torch.randn(self.num_envs, 4, generator=self.gen)
    return {'policy': x, 'critic': x.clone()}

  def init_state(self, seed=0):
    self.gen.manual_seed(seed)
    obs = self._obs()
    return {'obs': obs, 't': torch.zeros(self.num_envs, dtype=torch.int32)}, obs

  @property
  def step_fn(self):
    def step(state, action):
      target = state['obs']['policy'][:, :2]
      reward = -torch.sum(torch.square(action - target), dim=-1)
      t = state['t'] + 1
      truncated = t >= 8
      obs = self._obs()
      extras = {'time_outs': truncated,
                'reset_count': truncated.sum().to(torch.float32)}
      return ({'obs': obs, 't': torch.where(truncated, 0, t)},
              (obs, reward, torch.zeros_like(truncated), truncated, extras))
    return step


def _cfg(**kw):
  cfg = RslRlOnPolicyRunnerCfg(num_steps_per_env=8, device='cpu', **kw)
  cfg.policy.actor_hidden_dims = [32, 32]
  cfg.policy.critic_hidden_dims = [32, 32]
  cfg.algorithm.num_learning_epochs = 4
  cfg.algorithm.num_mini_batches = 2
  cfg.algorithm.learning_rate = 3e-3
  return cfg


def test_ppo_learns_contextual_task():
  """The counterpart of tests/test_rl.py::test_ppo_learns_contextual_task,
  with its thresholds."""
  ppo = PPO(FakeEnv(), _cfg())
  ts = ppo.init_state(0)
  rewards = []
  for _ in range(40):
    ts, logs = ppo.learn_iteration(ts)
    rewards.append(float(logs['mean_reward']))
  early = np.mean(rewards[:5])
  late = np.mean(rewards[-5:])
  # optimum is 0; the return must improve by >2x and reach a sane band
  assert late > early * 0.5, (early, late)
  assert late > -60.0, late


def _g1_cfg():
  cfg = registry.load_cfg(G1_FLAT_TASK, 'rl_cfg_entry_point')
  cfg.device = 'cpu'
  cfg.num_steps_per_env = 2
  cfg.policy.actor_hidden_dims = (16, 16)
  cfg.policy.critic_hidden_dims = (16,)
  return cfg


@pytest.fixture(scope='module')
def g1_env():
  return registry.make(G1_FLAT_TASK, device='cpu', **{'scene.num_envs': 2})


def _learner(runner):
  ts = runner.ts
  return ({k: p.detach().clone() for k, p in ts.net.named_parameters()},
          ts.adam, ts.lr.clone(), ts.iteration, ts.gen.get_state(),
          {k: v.clone() for k, v in ts.actor_norm.named_buffers()})


@pytest.mark.parametrize('full_state', [True, False])
def test_runner_checkpoint_roundtrip(g1_env, tmp_path, full_state):
  """A checkpoint restores params, Adam state, lr, iteration and the
  learner's generator bit for bit; with the env's state it restores that
  and the env's generator too, without it the fresh runner keeps its own.
  A resumed run numbers its checkpoints on from the loaded iteration."""
  runner = OnPolicyRunner(g1_env, _g1_cfg(), log_dir=str(tmp_path / 'a'))
  runner.learn(1)
  path = str(tmp_path / 'a' / 'model_1.pt')
  assert os.path.exists(path)
  runner.save(path, full_state=full_state)
  saved = _learner(runner)
  saved_env = env_state_to_numpy(runner.ts.env_state, g1_env)
  saved_env_gen = g1_env.generator.get_state()

  fresh = OnPolicyRunner(g1_env, _g1_cfg(), log_dir=str(tmp_path / 'b'))
  assert not all(torch.equal(fresh.ts.net.get_parameter(k), v)
                 for k, v in saved[0].items())
  fresh_env = env_state_to_numpy(fresh.ts.env_state, g1_env)
  fresh.load(path, load_env_state=True)
  params, adam, lr, it, gen, norm = _learner(fresh)
  assert it == 1 and torch.equal(lr, saved[2])
  assert torch.equal(gen, saved[4])
  for k, v in saved[0].items():
    assert torch.equal(params[k], v), k
    assert torch.equal(adam.mu[k], saved[1].mu[k]), k
    assert torch.equal(adam.nu[k], saved[1].nu[k]), k
  assert torch.equal(adam.count, saved[1].count)
  for k, v in saved[5].items():
    assert torch.equal(norm[k], v), k

  def same(a, b):
    if isinstance(a, dict):
      return all(same(a[k], b[k]) for k in a)
    return np.array_equal(a, b)

  loaded_env = env_state_to_numpy(fresh.ts.env_state, g1_env)
  assert same(loaded_env, saved_env if full_state else fresh_env)
  assert not same(saved_env, fresh_env)
  if full_state:
    assert torch.equal(g1_env.generator.get_state(), saved_env_gen)
    assert all(torch.equal(fresh.ts.obs[k], runner.ts.obs[k])
               for k in runner.ts.obs)

  fresh.learn(1)
  assert sorted(os.listdir(tmp_path / 'b')) == ['metrics.jsonl', 'model_2.pt']
  line = json.loads(open(tmp_path / 'b' / 'metrics.jsonl').read())
  assert line['iteration'] == 2


def test_train_writes_a_run_that_resumes_and_plays(tmp_path):
  """scripts/train.main on the G1 flat env (2 envs, 2 steps an iteration,
  one iteration; the velocity runner writes the deployment ONNX beside
  the checkpoint), a resumed run, then scripts/play.main of the newest
  checkpoint and of the first one by path."""
  base = ['Mjlab-Velocity-Flat-Unitree-G1', '--device', 'cpu',
          '--log-root', str(tmp_path), '--env.scene.num_envs', '2',
          '--agent.num_steps_per_env', '2', '--agent.max_iterations', '1']
  runner = train.main(base + SMALL + ['--run-name', 'first'])
  run = tmp_path / 'g1_flat' / 'first'
  assert sorted(os.listdir(run)) == ['agent_cfg.json', 'env_cfg.json',
                                     'metrics.jsonl', 'model_1.onnx',
                                     'model_1.onnx.meta.json', 'model_1.pt']
  agent = json.loads((run / 'agent_cfg.json').read_text())
  assert agent['policy']['actor_hidden_dims'] == [16, 16]
  assert agent['device'] == 'cpu' and agent['num_steps_per_env'] == 2
  assert json.loads((run / 'env_cfg.json').read_text())['scene'][
      'num_envs'] == 2
  logs = [json.loads(l) for l in (run / 'metrics.jsonl').read_text()
          .splitlines()]
  assert [l['iteration'] for l in logs] == [1]
  for k in ('loss', 'pg', 'v', 'ent', 'kl', 'std', 'lr', 'collection_ms',
            'learning_ms', 'mean_episode_length', 'env_steps_per_s'):
    assert np.isfinite(logs[0][k]), k
  assert runner.ts.iteration == 1

  resumed = train.main(base + SMALL + ['--run-name', 'second', '--resume'])
  assert resumed.ts.iteration == 2
  assert os.path.exists(tmp_path / 'g1_flat' / 'second' / 'model_2.pt')

  for extra in ([], ['--checkpoint', str(run / 'model_1.pt')]):
    stats = play.main(['Mjlab-Velocity-Flat-Unitree-G1', '--device', 'cpu',
                       '--log-root', str(tmp_path), '--num-envs', '2',
                       '--steps', '2'] + SMALL + extra)
    assert np.isfinite(stats['mean_reward'])


@pytest.mark.parametrize('flags,item', [
    (['--shard'], '12.9'), (['--agent.video', 'True'], '12.7')])
def test_unported_flags_exit_nonzero(tmp_path, flags, item):
  with pytest.raises(SystemExit) as e:
    train.main(['Mjlab-Velocity-Flat-Unitree-G1', '--device', 'cpu',
                '--log-root', str(tmp_path)] + flags)
  assert e.value.code not in (0, None)
  assert f'ROADMAP {item}' in str(e.value.code)
  assert not os.listdir(tmp_path)


def test_motion_task_gets_the_tracking_runner():
  """An env whose command term has a motion gets the tracking runner; an
  env without one, the velocity runner."""
  from mjlab_torch.rl.runner import (MotionTrackingOnPolicyRunner,
                                     VelocityOnPolicyRunner)

  class Term:
    motion = object()

  class Commands:
    terms = {'twist': object(), 'motion': Term()}

  env = FakeEnv()
  assert type(make_runner(env, _cfg())) is VelocityOnPolicyRunner
  env.command_manager = Commands()
  assert type(make_runner(env, _cfg())) is MotionTrackingOnPolicyRunner


def test_rollout_reads_one_device_value_an_env_step(g1_env, monkeypatch):
  """The rollout keeps the env's one host read an env-step
  (`bool(done.any())`) and adds none; the update reads none."""
  ppo = PPO(g1_env, _g1_cfg())
  ts = ppo.init_state(0)
  calls = []
  for name in ('__bool__', 'item', 'nonzero', 'cpu', 'tolist', 'numpy',
               '__int__', '__float__', '__index__'):
    orig = getattr(torch.Tensor, name)

    def counted(self, *a, _orig=orig, _name=name, **kw):
      calls.append(_name)
      return _orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, name, counted)
  traj, last_value, _, _ = ppo._rollout(ts)
  rollout_calls, calls[:] = list(calls), []
  adv, returns = ppo._gae(traj, last_value)
  ppo._update(ts, traj, adv, returns)
  monkeypatch.undo()
  assert rollout_calls == ['__bool__'] * ppo.cfg.num_steps_per_env
  assert calls == []
