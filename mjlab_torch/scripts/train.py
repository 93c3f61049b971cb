"""Train a task's policy with PPO.

Counterpart of mjlab_tpu/scripts/train.py:

    python -m mjlab_torch.scripts.train Mjlab-Velocity-Flat-Unitree-G1 \\
        --env.scene.num_envs 4096 --agent.max_iterations 1000

Runs on the GPU unless `--device cpu` is given. Each run writes
`env_cfg.json`, `agent_cfg.json`, `metrics.jsonl` and `model_{it}.pt` to
`<log-root>/<experiment_name>/<run-name>`; `--resume` first loads the newest
checkpoint of the experiment's earlier runs and numbers on from it.
`--env.*` and `--agent.*` set fields of the env and the agent cfg.

`--enable-nan-guard` wraps the env's step in a NanGuard
(utils/nan_guard.py) that dumps the first non-finite state to
`<run>/nan_dumps` (read it with `python -m mjlab_torch.scripts.nan_viz`).
With `MJLAB_BLOWUP_DUMP=<dir>` in the environment the env keeps the
pre-substep state of envs that blew up in a device ring, written to
`<dir>/blowup_ring.npz` at every logged iteration (replay it with
`python -m mjlab_torch.scripts.blowup_replay <dir>`).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('task', help='registered task id')
  parser.add_argument('--log-root', default='logs')
  parser.add_argument('--resume', action='store_true')
  parser.add_argument('--run-name', default=None)
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--enable-nan-guard', action='store_true',
                      help='dump the first non-finite physics state to '
                      '<run>/nan_dumps')
  parser.add_argument('--shard', action='store_true',
                      help='not ported yet (ROADMAP 12.9)')
  args, overrides = parser.parse_known_args(argv)
  if args.shard:
    raise SystemExit('--shard: multi-GPU sharding is not ported yet '
                     '(ROADMAP 12.9)')

  from mjlab_torch.rl.runner import get_checkpoint_path, make_runner
  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.cli import (apply_overrides, cfg_to_dict,
                                     route_overrides)
  from mjlab_torch.utils.tables import env_summary

  env_cfg = registry.load_cfg(args.task, 'env_cfg_entry_point')
  agent_cfg = registry.load_cfg(args.task, 'rl_cfg_entry_point')
  env_over, agent_over = route_overrides(overrides)
  apply_overrides(env_cfg, env_over)
  apply_overrides(agent_cfg, agent_over)
  agent_cfg.device = args.device
  if agent_cfg.video:
    raise SystemExit('video=True: training videos are not ported yet '
                     '(ROADMAP 12.7, 12.10)')

  exp_root = os.path.join(args.log_root, agent_cfg.experiment_name)
  # the checkpoint to resume is found before this run's directory exists,
  # which would otherwise be the newest run, without a checkpoint
  ckpt = (get_checkpoint_path(exp_root, agent_cfg.load_run,
                              agent_cfg.load_checkpoint)
          if args.resume or agent_cfg.resume else None)
  stamp = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
  log_dir = os.path.join(exp_root, args.run_name or stamp)
  os.makedirs(log_dir, exist_ok=True)
  for name, cfg in (('env_cfg', env_cfg), ('agent_cfg', agent_cfg)):
    with open(os.path.join(log_dir, f'{name}.json'), 'w') as f:
      json.dump(cfg_to_dict(cfg), f, indent=2, default=repr)

  env = registry.make(args.task, cfg=env_cfg, device=args.device)
  step_fn = None
  if args.enable_nan_guard:
    from mjlab_torch.utils.nan_guard import NanGuard
    step_fn = NanGuard(
        env, out_dir=os.path.join(log_dir, 'nan_dumps')).wrap(env.step_fn)
  runner = make_runner(env, agent_cfg, log_dir=log_dir, step_fn=step_fn)
  if ckpt is not None:
    print(f'[resume] loading {ckpt}')
    runner.load(ckpt)
  print(env_summary(env), flush=True)
  print(f'[train] task={args.task} envs={env.num_envs} '
        f'action_dim={env.action_dim} obs={env.observation_dims} '
        f'device={env.device} log_dir={log_dir}', flush=True)
  try:
    runner.learn(agent_cfg.max_iterations)
  finally:
    runner.close()
  return runner


if __name__ == '__main__':
  main()
