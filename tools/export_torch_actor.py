"""Write the PyTorch port's copy of a trained policy's actor.

Restores an orbax checkpoint of the JAX package's runner, keeps the actor's
layers and the actor's observation normalizer, and writes them as the .npz
that `mjlab_torch.rl.networks.load_actor` reads (which needs neither orbax
nor flax). Whether the policy normalizes its observations comes from the
task's runner configuration. Before writing it checks the checkpoint
against the exported policy's metadata beside it: the action width equals
the joint count, and the observation width is the task's (velocity: 3 + 3
+ 3 + 3 * joints + 3; tracking: 2 * joints + 3 + 6 + 3 + 3 + 3 * joints).

Usage (the shipped G1 flat policy, the shipped G1 tracking policy, or any):
  python tools/export_torch_actor.py
  python tools/export_torch_actor.py tracking
  python tools/export_torch_actor.py <task> <src_ckpt_dir> <dst_npz>
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the CPU backend, before orbax pulls in jax
import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

G1_FLAT = ('Mjlab-Velocity-Flat-Unitree-G1',
           os.path.join(ROOT, 'mjlab_tpu/asset_zoo/pretrained/g1_flat/'
                        'model_4500.ckpt'),
           os.path.join(ROOT, 'mjlab_torch/asset_zoo/pretrained/g1_flat/'
                        'model_4500.npz'))
G1_TRACKING = ('Mjlab-Tracking-Flat-Unitree-G1',
               os.path.join(ROOT, 'mjlab_tpu/asset_zoo/pretrained/'
                            'g1_tracking/model_6000.ckpt'),
               os.path.join(ROOT, 'mjlab_torch/asset_zoo/pretrained/'
                            'g1_tracking/model_6000.npz'))


def obs_width(task: str, joints: int) -> int:
  """The policy observation width of a velocity or tracking task."""
  if task.startswith('Mjlab-Tracking-'):
    return 5 * joints + 15
  return 3 * joints + 12


def restore(src: str) -> dict:
  """The checkpoint's tree as numpy arrays."""
  import numpy as np
  import orbax.checkpoint as ocp
  full = ocp.PyTreeCheckpointer().restore(os.path.abspath(src))
  return jax.tree.map(np.asarray, full)


def export(task: str, src: str, dst: str) -> None:
  from mjlab_tpu.tasks import registry
  from mjlab_torch.rl.networks import save_actor
  full = restore(src)
  policy = registry.load_cfg(task, 'rl_cfg_entry_point').policy
  actor = full['params']['params']['actor']
  obs_dim = actor['Dense_0']['kernel'].shape[0]
  act_dim = actor[f'Dense_{len(actor) - 1}']['kernel'].shape[1]
  meta_path = os.path.splitext(src)[0] + '.onnx.meta.json'
  with open(meta_path) as f:
    joints = json.load(f)['joint_names']
  if act_dim != len(joints) or obs_dim != obs_width(task, len(joints)):
    raise ValueError(
        f'{src}: actor maps {obs_dim} -> {act_dim}, but {meta_path} names '
        f'{len(joints)} joints')
  save_actor(dst, full['params'], full['actor_norm'],
             bool(policy.actor_obs_normalization), policy.activation)
  print(f'{src} -> {dst}: obs {obs_dim}, actions {act_dim}, '
        f'normalize_obs {policy.actor_obs_normalization}, '
        f'{os.path.getsize(dst) / 2**10:.0f} KiB')


if __name__ == '__main__':
  if len(sys.argv) == 1:
    export(*G1_FLAT)
  elif sys.argv[1:] == ['tracking']:
    export(*G1_TRACKING)
  else:
    export(*sys.argv[1:4])
