"""The harness's look for a chip skipped, a whole run of each cell on the
CPU at a tiny size with the timed path broken underneath: `correct` comes
out false for each fault the cell can have. (The exchange between chips
has no fault here: every cell runs on one chip.)"""

import json

import pytest
import torch

from benchmark.lib import harness, spec
from benchmark.tests import tiny

BENCH = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())
DRIVER = {w['name']: json.loads((spec.WORKLOADS / f'{w["name"]}.json')
                                .read_text())['driver']
          for w in BENCH['workloads']}


def unchanged_step(monkeypatch):
  """The physics step returns its state unchanged."""
  from mjlab_torch.physics import pipeline
  monkeypatch.setattr(pipeline, 'step', lambda m, d: d)


def half_the_batch(monkeypatch):
  """Half of the batch left out: the learner's loss is the mean over the
  first half of each minibatch; the env-step advances the first half of
  the envs and leaves the rest where they were."""
  from mjlab_torch.physics import pipeline
  from mjlab_torch.rl import ppo
  loss = ppo.PPO._loss
  monkeypatch.setattr(ppo.PPO, '_loss', lambda self, net, mb, old_std: loss(
      self, net, tuple(x[:x.shape[0] // 2] for x in mb), old_std))
  step = pipeline.step

  def half(m, d):
    out = step(m, d)
    h = d.qpos.shape[0] // 2
    return out.replace(qpos=torch.cat([out.qpos[:h], d.qpos[h:]]),
                       qvel=torch.cat([out.qvel[:h], d.qvel[h:]]))
  monkeypatch.setattr(pipeline, 'step', half)


def altered_answer(monkeypatch):
  """An answer altered where it is produced: env 0's reward, and env 0's
  first action component from the actor, moved by 0.01."""
  from mjlab_torch.managers import managers
  from mjlab_torch.rl import networks
  compute = managers.RewardManager.compute

  def reward(self, *a, **k):
    out = compute(self, *a, **k)
    r = out[0].clone()
    r[0] += 0.01
    return (r,) + tuple(out[1:])
  monkeypatch.setattr(managers.RewardManager, 'compute', reward)
  act = networks.Actor.act_mean

  def actor(self, obs):
    a = act(self, obs).clone()
    a[0, 0] += 0.01
    return a
  monkeypatch.setattr(networks.Actor, 'act_mean', actor)


def few_envs(monkeypatch):
  """The physics wrong in a few envs: each substep's velocities 1 % off
  in one env of every 32 (env 0 at a test's size)."""
  from mjlab_torch.physics import pipeline
  step = pipeline.step

  def off(m, d):
    out = step(m, d)
    qvel = out.qvel.clone()
    qvel[::32] *= 1.01
    return out.replace(qvel=qvel)
  monkeypatch.setattr(pipeline, 'step', off)


FAULTS = {'unchanged_step': unchanged_step, 'half_the_batch': half_the_batch,
          'altered_answer': altered_answer, 'few_envs': few_envs}


@pytest.mark.parametrize('fault', sorted(FAULTS))
@pytest.mark.parametrize('name', sorted(DRIVER))
def test_fault_makes_the_run_incorrect(monkeypatch, name, fault):
  torch.set_num_threads(2)
  cell, overrides = tiny.shrink(spec.load_cell(name))
  assert cell.traffic['limits'], 'the cell states no limits'
  FAULTS[fault](monkeypatch)
  res = harness.run_cell(cell, 7, 0.2, traced=False, device='cpu',
                         overrides=overrides)
  failing = [k for k, c in res['checks'].items()
             if c['value'] is None or not c['value'] <= c['limit']]
  assert not res['correct'], res['checks']
  assert failing
