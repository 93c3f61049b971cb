"""What the shard-aware draws of `train.py --shard` cost: the random numbers
a training rollout draws over the env axis, per env and env-step.

A sharded rank draws every env-axis draw at the global env count and keeps
its rows (utils/math.py: ShardedGenerator, env_rows), so at a world of W a
rank draws W times the numbers its own envs need, in the same launches.
This counts them for one rollout of PPO on the CPU (the env's resets,
commands, pushes and observation noise, and the learner's action noise).

    python tools/shard_draw_count.py [TASK] [ENVS] [STEPS]
    # default Mjlab-Velocity-Flat-Unitree-G1 4 4
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
  from mjlab_torch.rl.ppo import PPO
  from mjlab_torch.tasks import registry
  from mjlab_torch.utils import math as tmath
  task = sys.argv[1] if len(sys.argv) > 1 else 'Mjlab-Velocity-Flat-Unitree-G1'
  envs, steps = ([int(a) for a in sys.argv[2:4]] + [4, 4][len(sys.argv[2:4]):])
  drawn = [0]
  env_rows = tmath.env_rows

  def counted(gen, draw, shape):
    out = env_rows(gen, draw, shape)
    drawn[0] += out.numel()
    return out

  tmath.env_rows = counted
  env = registry.make(task, device='cpu', **{'scene.num_envs': envs})
  cfg = registry.load_cfg(task, 'rl_cfg_entry_point')
  cfg.device, cfg.num_steps_per_env = 'cpu', steps
  ppo = PPO(env, cfg)
  ts = ppo.init_state()
  drawn[0] = 0
  ppo._rollout(ts)
  per = drawn[0] / (envs * steps)
  print(f'{task}: {per:g} random numbers an env an env-step over a rollout '
        f'of {steps} env-steps at {envs} envs on the CPU; a rank of a world '
        f'of W draws W x that for each of its envs')


if __name__ == '__main__':
  main()
