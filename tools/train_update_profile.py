"""Where a PPO update of the PyTorch port spends its time on the GPU.

Builds `Mjlab-Velocity-Flat-Unitree-G1` at the given width on the card with
the registered learner (actor and critic (512, 256, 128), 5 epochs x 4
minibatches), collects one rollout of 24 env-steps, then times GAE and the
update (`PPO._gae` + `PPO._update`, the 'learning' stage of an iteration)
  1. unprofiled, host clock around work that ends in a synchronize;
  2. under torch.profiler: the CUDA kernels and the host ops by total time,
     and the share of the update in which the device was busy.
The update's float32 products are counted from the widths (forward and
backward of both MLPs) and printed beside their time at 67 TFLOP/s.

    python3 tools/train_update_profile.py [num_envs] [repeats]

Needs one NVIDIA GPU and the CUDA toolkit (the kernels are built on first
use). Prints the card's name and power limit first.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TASK = 'Mjlab-Velocity-Flat-Unitree-G1'
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores


def mlp_macs(dims) -> int:
  return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def main(num_envs: int = 4096, repeats: int = 3) -> None:
  import torch
  if not torch.cuda.is_available():
    sys.exit('train_update_profile: needs an NVIDIA GPU')
  from mjlab_torch.rl.ppo import PPO
  from mjlab_torch.tasks import registry
  print(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip(), flush=True)
  env = registry.make(TASK, **{'scene.num_envs': num_envs})
  cfg = registry.load_cfg(TASK, 'rl_cfg_entry_point')
  ppo = PPO(env, cfg)
  ts = ppo.init_state()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  traj, last_value, _, _ = ppo._rollout(ts)
  torch.cuda.synchronize()
  print(f'{num_envs} envs: one rollout of {cfg.num_steps_per_env} env-steps '
        f'in {(time.perf_counter() - t0) * 1e3:.1f} ms', flush=True)

  def update():
    adv, ret = ppo._gae(traj, last_value)
    ppo._update(ts, traj, adv, ret)

  def run(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
      update()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3

  update()  # warm-up: cuBLAS handles, autograd's first graph
  plain_ms = run(repeats)
  alg, pol = cfg.algorithm, cfg.policy
  samples = cfg.num_steps_per_env * num_envs * alg.num_learning_epochs
  macs = (mlp_macs([ppo.actor_dim, *pol.actor_hidden_dims, ppo.action_dim])
          + mlp_macs([ppo.critic_dim, *pol.critic_hidden_dims, 1]))
  flops = 3 * 2 * macs * samples  # forward, and backward at twice forward
  steps = alg.num_learning_epochs * alg.num_mini_batches
  print(f'GAE + update: {plain_ms:.2f} ms unprofiled (mean of {repeats}); '
        f'{steps} Adam steps on {samples // steps} '
        f'samples each; products {flops / 1e12:.3f} TFLOP = '
        f'{flops / F32_FLOPS_PER_S * 1e3:.2f} ms at 67 TFLOP/s', flush=True)

  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as tp:
    ms = run(repeats)
  print(f'under torch.profiler: {ms:.2f} ms an update', flush=True)
  avg = tp.key_averages()
  print(avg.table(sort_by='cuda_time_total', row_limit=15), flush=True)
  print(avg.table(sort_by='self_cpu_time_total', row_limit=12), flush=True)
  # kernels only: a host op's row repeats the time of the kernels it launched
  kernels = [e for e in avg if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / repeats
  launches = sum(e.count for e in kernels) / repeats
  print(f'device busy {busy_ms:.2f} ms an update ({launches:.0f} kernel '
        f'launches): {busy_ms / plain_ms:.3f} of the unprofiled '
        f'{plain_ms:.2f} ms, {busy_ms / ms:.3f} of the profiled {ms:.2f} ms',
        flush=True)


if __name__ == '__main__':
  main(*(int(a) for a in sys.argv[1:3]))
