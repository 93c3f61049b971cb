"""Train a task's policy with PPO.

Counterpart of mjlab_tpu/scripts/train.py:

    python -m mjlab_torch.scripts.train Mjlab-Velocity-Flat-Unitree-G1 \\
        --env.scene.num_envs 4096 --agent.max_iterations 1000

Runs on the GPU unless `--device cpu` is given. Each run writes
`env_cfg.json`, `agent_cfg.json`, `metrics.jsonl` and `model_{it}.pt` to
`<log-root>/<experiment_name>/<run-name>`; `--resume` first loads the newest
checkpoint of the experiment's earlier runs and numbers on from it.
`--env.*` and `--agent.*` set fields of the env and the agent cfg;
`--agent.video True` (with `--agent.video_interval` and
`--agent.video_length`) writes training videos of env 0 to
`<run>/videos/train` (rl/runner.py).

`--enable-nan-guard` wraps the env's step in a NanGuard
(utils/nan_guard.py) that dumps the first non-finite state to
`<run>/nan_dumps` (read it with `python -m mjlab_torch.scripts.nan_viz`).
With `MJLAB_BLOWUP_DUMP=<dir>` in the environment the env keeps the
pre-substep state of envs that blew up in a device ring, written to
`<dir>/blowup_ring.npz` at every logged iteration (replay it with
`python -m mjlab_torch.scripts.blowup_replay <dir>`).

`--shard` trains one policy over several processes, one a card
(parallel/sharding.py): under `torch.distributed.run` (`--nproc_per_node`,
and `--nnodes` across hosts) it takes the launcher's ranks; started plainly
on CUDA it starts one process for each visible card; on the CPU without a
launcher the world is one process. `--env.scene.num_envs` stays the global
env count, divisible by the world size; each rank steps its share on its
own card with the whole learner. Rank 0 prints and writes the run
directory, whose checkpoints hold every rank's envs; with
`--enable-nan-guard` each rank dumps to `<run>/nan_dumps/rank<r>`.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys


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
                      help='train over every visible card, one process '
                      'each (or the ranks of torch.distributed.run); '
                      'num_envs is global')
  args, overrides = parser.parse_known_args(argv)
  if args.shard and _spawn_workers(args, argv):
    return None

  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.cli import apply_overrides, route_overrides

  env_cfg = registry.load_cfg(args.task, 'env_cfg_entry_point')
  agent_cfg = registry.load_cfg(args.task, 'rl_cfg_entry_point')
  env_over, agent_over = route_overrides(overrides)
  apply_overrides(env_cfg, env_over)
  apply_overrides(agent_cfg, agent_over)
  agent_cfg.device = args.device

  world = None
  device = args.device
  if args.shard:
    from mjlab_torch.parallel.sharding import init_world
    world = init_world(env_cfg.scene.num_envs, args.device)
    device = world.device
  try:
    return _train(args, env_cfg, agent_cfg, world, device)
  finally:
    if world is not None:
      from mjlab_torch.parallel.sharding import close_world
      close_world(world)


def _train(args, env_cfg, agent_cfg, world, device):
  from mjlab_torch.rl.runner import get_checkpoint_path, make_runner
  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.cli import cfg_to_dict
  from mjlab_torch.utils.tables import env_summary

  main_rank = world is None or world.is_main
  if world is not None:
    print(f'[train] rank {world.rank} of a world of {world.size} over '
          f'{world.backend}: envs {world.offset}..'
          f'{world.offset + world.n_local - 1} of {world.num_envs} on '
          f'{world.device}', flush=True)
    if world.device.type == 'cuda':
      # the first rank of each host compiles the kernels into its checkout
      # (ops/_build.py replaces a build atomically, so hosts sharing one
      # checkout may both build); the others load what it built
      if world.local_rank == 0:
        from mjlab_torch.ops import build_all
        build_all()
      world.barrier()

  log_dir = ckpt = None
  if main_rank:
    exp_root = os.path.join(args.log_root, agent_cfg.experiment_name)
    # the checkpoint to resume is found before this run's directory
    # exists, which would otherwise be the newest run, without a checkpoint
    ckpt = (get_checkpoint_path(exp_root, agent_cfg.load_run,
                                agent_cfg.load_checkpoint)
            if args.resume or agent_cfg.resume else None)
    stamp = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
    log_dir = os.path.join(exp_root, args.run_name or stamp)
    os.makedirs(log_dir, exist_ok=True)
    for name, cfg in (('env_cfg', env_cfg), ('agent_cfg', agent_cfg)):
      with open(os.path.join(log_dir, f'{name}.json'), 'w') as f:
        json.dump(cfg_to_dict(cfg), f, indent=2, default=repr)
  if world is not None:
    from mjlab_torch.parallel.sharding import broadcast_object
    log_dir, ckpt = broadcast_object((log_dir, ckpt), world)

  env = registry.make(args.task, cfg=env_cfg, device=device, world=world)
  step_fn = None
  if args.enable_nan_guard:
    from mjlab_torch.utils.nan_guard import NanGuard
    out_dir = os.path.join(log_dir, 'nan_dumps')
    if world is not None and world.sharded:
      out_dir = os.path.join(out_dir, f'rank{world.rank}')
    step_fn = NanGuard(env, out_dir=out_dir).wrap(env.step_fn)
  runner = make_runner(env, agent_cfg, log_dir=log_dir, step_fn=step_fn)
  if ckpt is not None:
    if main_rank:
      print(f'[resume] loading {ckpt}')
    runner.load(ckpt)
  if main_rank:
    print(env_summary(env), flush=True)
    print(f'[train] task={args.task} envs={runner.world.num_envs} '
          f'action_dim={env.action_dim} obs={env.observation_dims} '
          f'device={env.device} log_dir={log_dir}', flush=True)
  try:
    runner.learn(agent_cfg.max_iterations)
  finally:
    runner.close()
  return runner


def _spawn_workers(args, argv) -> bool:
  """`--shard` started plainly on a host with more than one visible card:
  run main in one process for each, as ranks of one world on this host,
  and return True when they are done (a worker that fails raises here).
  False (nothing started) under a launcher, on the CPU or on one card."""
  import torch
  if 'WORLD_SIZE' in os.environ or args.device == 'cpu' or not (
      torch.cuda.is_available() and torch.cuda.device_count() > 1):
    return False
  import torch.multiprocessing as mp

  from mjlab_torch.parallel.sharding import free_port
  n = torch.cuda.device_count()
  argv = sys.argv[1:] if argv is None else list(argv)
  mp.spawn(_worker, args=(argv, n, free_port()), nprocs=n, join=True)
  return True


def _worker(rank: int, argv, size: int, port: int) -> None:
  os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                    WORLD_SIZE=str(size), MASTER_ADDR='127.0.0.1',
                    MASTER_PORT=str(port))
  main(argv)


if __name__ == '__main__':
  main()
