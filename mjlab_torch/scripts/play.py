"""Roll a zero, random or trained policy through a task's environment and
report reward and reset statistics.

Counterpart of mjlab_tpu/scripts/play.py without rendering and viewers:

    python -m mjlab_torch.scripts.play Mjlab-Velocity-Flat-Unitree-G1-Play \\
        --agent trained --steps 300

Runs on the GPU unless `--device cpu` is given. `--agent trained` loads the
task's shipped policy, or the .npz given by `--checkpoint`.
"""

from __future__ import annotations

import argparse


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('task')
  parser.add_argument('--agent', choices=['zero', 'random', 'trained'],
                      default='trained')
  parser.add_argument('--checkpoint', default=None,
                      help='actor .npz (rl/networks.py:save_actor)')
  parser.add_argument('--steps', type=int, default=300)
  parser.add_argument('--num-envs', type=int, default=None)
  parser.add_argument('--device', default='cuda')
  args = parser.parse_args(argv)

  import torch

  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.tasks import registry

  overrides = {}
  if args.num_envs is not None:
    overrides['scene.num_envs'] = args.num_envs
  env = registry.make(args.task, device=args.device, **overrides)
  dev = env.device

  if args.agent == 'zero':
    policy = lambda obs: torch.zeros((env.num_envs, env.action_dim),
                                     device=dev)
  elif args.agent == 'random':
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    policy = lambda obs: torch.randn((env.num_envs, env.action_dim),
                                     generator=gen, device=dev)
  else:
    ckpt = args.checkpoint or registry.load_cfg(args.task,
                                                'pretrained_policy')
    print(f'[play] loading {ckpt}')
    policy = load_actor(ckpt, device=dev)

  obs, _ = env.reset()
  # sums stay on the device; the host reads them once, after the loop
  rew_sum = torch.zeros((), device=dev)
  resets = torch.zeros((), dtype=torch.long, device=dev)
  ep_len_sum = torch.zeros((), device=dev)
  for _ in range(args.steps):
    obs, rew, term, trunc, extras = env.step(policy(obs))
    rew_sum += rew.mean()
    resets += (term | trunc).sum()
    ep_len_sum += extras['episode_length_sum']
  resets = int(resets)
  ep_msg = (f', mean episode length: {float(ep_len_sum) / resets:.1f}'
            if resets else '')
  print(f'[play] {args.steps} steps, mean reward/step: '
        f'{float(rew_sum) / args.steps:.4f}, resets: {resets}{ep_msg}')


if __name__ == '__main__':
  main()
