"""Roll a zero, random or trained policy through a task's environment and
report reward and reset statistics.

Counterpart of mjlab_tpu/scripts/play.py without rendering and viewers:

    python -m mjlab_torch.scripts.play Mjlab-Velocity-Flat-Unitree-G1-Play \\
        --agent trained --steps 300

Runs on the GPU unless `--device cpu` is given. `--agent trained` plays a
runner checkpoint (`model_{it}.pt`: the one `--checkpoint` names, else the
newest under `--log-root/<experiment_name>`) through the runner's inference
policy; an actor .npz (rl/networks.py:save_actor) named by `--checkpoint`
plays as it is, and the task's shipped policy plays when there is no run.
The shipped tracking policy plays on the clip it was trained on, shipped
beside it, unless `--env.commands.motion.motion_file` names another.
`--env.*` and `--agent.*` set fields of the env and the agent cfg (the
agent's network widths must be those of the checkpoint). The statistics
count the resets by cause and average each command metric over the
steps and envs.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('task')
  parser.add_argument('--agent', choices=['zero', 'random', 'trained'],
                      default='trained')
  parser.add_argument('--checkpoint', default=None,
                      help='runner checkpoint (.pt) or actor (.npz)')
  parser.add_argument('--log-root', default='logs')
  parser.add_argument('--steps', type=int, default=300)
  parser.add_argument('--num-envs', type=int, default=None)
  parser.add_argument('--device', default='cuda')
  args, overrides = parser.parse_known_args(argv)

  import torch

  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.rl.runner import OnPolicyRunner, get_checkpoint_path
  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.cli import apply_overrides, route_overrides

  env_cfg = registry.load_cfg(args.task, 'env_cfg_entry_point')
  agent_cfg = registry.load_cfg(args.task, 'rl_cfg_entry_point')
  env_over, agent_over = route_overrides(overrides)
  apply_overrides(env_cfg, env_over)
  apply_overrides(agent_cfg, agent_over)
  agent_cfg.device = args.device
  if args.num_envs is not None:
    env_cfg.scene.num_envs = args.num_envs
  ckpt = args.checkpoint
  if args.agent == 'trained':
    if ckpt is None:
      try:
        ckpt = get_checkpoint_path(
            f'{args.log_root}/{agent_cfg.experiment_name}',
            agent_cfg.load_run, agent_cfg.load_checkpoint)
      except FileNotFoundError:
        ckpt = str(registry.load_cfg(args.task, 'pretrained_policy'))
    _shipped_policy_motion(args.task, ckpt, env_cfg, env_over)
  env = registry.make(args.task, cfg=env_cfg, device=args.device)
  dev = env.device
  motion_file = getattr(getattr(env_cfg.commands, 'motion', None),
                        'motion_file', None)
  if motion_file:
    print(f'[play] motion {motion_file}')

  if args.agent == 'zero':
    policy = lambda obs: torch.zeros((env.num_envs, env.action_dim),
                                     device=dev)
  elif args.agent == 'random':
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    policy = lambda obs: torch.randn((env.num_envs, env.action_dim),
                                     generator=gen, device=dev)
  else:
    print(f'[play] loading {ckpt}')
    if ckpt.endswith('.npz'):
      policy = load_actor(ckpt, device=dev)
    else:
      runner = OnPolicyRunner(env, agent_cfg)
      runner.load(ckpt)
      policy = runner.get_inference_policy()

  obs, _ = env.reset()
  cm = env.command_manager
  # sums stay on the device; the host reads them once, after the loop
  rew_sum = torch.zeros((), device=dev)
  resets = torch.zeros((), dtype=torch.long, device=dev)
  ep_len_sum = torch.zeros((), device=dev)
  causes, metrics = {}, {}
  for _ in range(args.steps):
    obs, rew, term, trunc, extras = env.step(policy(obs))
    rew_sum += rew.mean()
    resets += (term | trunc).sum()
    ep_len_sum += extras['episode_length_sum']
    for k, v in extras.items():
      if k.startswith('Episode_Termination/'):
        causes[k.split('/', 1)[1]] = causes.get(k.split('/', 1)[1], 0) + v
    for name, t in cm.terms.items():
      for k, v in t.metrics(env.state.command[name]).items():
        metrics[f'{name}/{k}'] = metrics.get(f'{name}/{k}', 0) + v.mean()
  stats = {'mean_reward': float(rew_sum) / args.steps, 'resets': int(resets),
           'mean_episode_length': (float(ep_len_sum) / int(resets)
                                   if int(resets) else None),
           'terminations': {k: int(v) for k, v in causes.items()},
           'metrics': {k: float(v) / args.steps for k, v in metrics.items()},
           'motion_file': motion_file}
  ep_msg = (f', mean episode length: {stats["mean_episode_length"]:.1f}'
            if stats['resets'] else '')
  print(f'[play] {args.steps} steps, mean reward/step: '
        f'{stats["mean_reward"]:.4f}, resets: {stats["resets"]}{ep_msg}; '
        f'by cause {stats["terminations"]}')
  return stats


def _shipped_policy_motion(task, ckpt, env_cfg, env_over):
  """The task's shipped policy plays on the motion clip it was trained on
  (the registry's `pretrained_motion`), unless the caller names a clip."""
  from mjlab_torch.tasks import registry
  try:
    shipped = registry.load_cfg(task, 'pretrained_policy')
    clip = registry.load_cfg(task, 'pretrained_motion')
  except KeyError:
    return
  named = any('motion_file' in tok for tok in env_over)
  if os.path.abspath(ckpt) == os.path.abspath(shipped) and not named:
    env_cfg.commands.motion.motion_file = str(clip)


if __name__ == '__main__':
  main()
