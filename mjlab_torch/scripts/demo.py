"""Demo: play a trained policy of a task, training one first if none exists.

Counterpart of mjlab_tpu/scripts/demo.py without the viewer:

    python -m mjlab_torch.scripts.demo [--task Mjlab-Velocity-Flat-Unitree-Go1]

The policy is, in this order: the newest checkpoint of the task's
experiment under `--log-root` (a policy the user trained wins), the task's
shipped policy (`pretrained_policy` in the registry), or a policy trained
here for `--train-iterations` PPO iterations at `--num-envs` envs through
scripts/train.py, which also exports its ONNX on every save. Then
scripts/play.py plays it for `--steps` env-steps at up to 16 envs; the
shipped tracking policy plays on the clip it was trained on, which ships
beside it, unless `--env.commands.motion.motion_file` names another. Runs on
the GPU unless `--device cpu` is given. Other `--env.*` and `--agent.*`
flags go to both scripts. Returns the checkpoint played, the training
runner (None when nothing was trained) and play's statistics.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('--task', default='Mjlab-Velocity-Flat-Unitree-Go1')
  p.add_argument('--log-root', default='logs')
  p.add_argument('--train-iterations', type=int, default=300)
  p.add_argument('--num-envs', type=int, default=None,
                 help='training envs (default: the task cfg\'s)')
  p.add_argument('--steps', type=int, default=300)
  p.add_argument('--device', default='cuda')
  args, extra = p.parse_known_args(argv)

  from mjlab_torch.rl.runner import get_checkpoint_path
  from mjlab_torch.scripts import play, train
  from mjlab_torch.tasks import registry

  agent_cfg = registry.load_cfg(args.task, 'rl_cfg_entry_point')
  exp_root = os.path.join(args.log_root, agent_cfg.experiment_name)
  try:
    ckpt = get_checkpoint_path(exp_root)
    print(f'[demo] found local checkpoint {ckpt}', flush=True)
  except (FileNotFoundError, OSError):
    ckpt = None
  if ckpt is None:
    try:
      ckpt = str(registry.load_cfg(args.task, 'pretrained_policy'))
      print(f'[demo] using the shipped policy {ckpt}', flush=True)
    except KeyError:
      pass
  runner = None
  if ckpt is None:
    print(f'[demo] no checkpoint under {exp_root} and no shipped policy; '
          f'training {args.train_iterations} iterations first', flush=True)
    train_args = [args.task, '--log-root', args.log_root, '--run-name',
                  'demo', '--device', args.device, '--agent.max_iterations',
                  str(args.train_iterations)]
    if args.num_envs is not None:
      train_args += ['--env.scene.num_envs', str(args.num_envs)]
    runner = train.main(train_args + list(extra))
    ckpt = get_checkpoint_path(exp_root)

  stats = play.main([args.task, '--agent', 'trained', '--checkpoint', ckpt,
                     '--log-root', args.log_root, '--steps', str(args.steps),
                     '--num-envs', str(min(args.num_envs or 16, 16)),
                     '--device', args.device] + list(extra))
  return {'checkpoint': ckpt, 'runner': runner, 'play': stats}


if __name__ == '__main__':
  main()
