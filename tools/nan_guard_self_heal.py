"""Does a NaN guard on the env's step see a blowup? The JAX package's and
the port's, side by side, on the CPU.

The JAX env's step sanitizes its Data (`nan_to_num`) before it returns,
and mjlab_tpu's NanGuard checks the state the step returns, so it can
never fire on the env path. The port's guard is handed the state before
the self-heal. This puts NaN into env 1's qvel and takes one env-step
through each package's `NanGuard(env).wrap(env.step_fn)`:

- JAX: `Mjlab-Velocity-Flat-Tiny` at 4 envs (about 40 s: the env build and
  its jit);
- port: `Mjlab-Velocity-Flat-Unitree-G1` at 4 envs (the port has no Tiny
  task).

and prints, for each, the env's physics_nan count, whether env 1 was
terminated, and the dumps the guard wrote.

    python tools/nan_guard_self_heal.py
"""

from __future__ import annotations

import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ['JAX_PLATFORMS'] = 'cpu'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')


def jax_leg(out: str) -> dict:
  import jax.numpy as jnp

  import mjlab_tpu.tasks.velocity.config.tiny  # noqa: F401
  from mjlab_tpu.tasks import registry
  from mjlab_tpu.utils.nan_guard import NanGuard
  cfg = registry.load_cfg('Mjlab-Velocity-Flat-Tiny')
  cfg.scene.num_envs = 4
  env = registry.make('Mjlab-Velocity-Flat-Tiny', cfg=cfg)
  state, _ = env.init_state(0)
  state = state.replace(data=state.data.replace(
      qvel=state.data.qvel.at[1, 0].set(jnp.nan)))
  step = jax.jit(NanGuard(env, out_dir=out).wrap(env.step_fn))
  state, (_, _, term, _, extras) = step(state, jnp.zeros((4, env.action_dim)))
  jax.block_until_ready(state.data.qpos)
  jax.effects_barrier()
  return dict(physics_nan=int(extras['Episode_Termination/physics_nan']),
              env1_terminated=bool(term[1]),
              dumps=len(glob.glob(os.path.join(out, 'nan_dump_*.npz'))))


def port_leg(out: str) -> dict:
  import torch

  from mjlab_torch.tasks import registry
  from mjlab_torch.utils.nan_guard import NanGuard
  env = registry.make('Mjlab-Velocity-Flat-Unitree-G1', device='cpu',
                      **{'scene.num_envs': 4})
  state, _ = env.init_state(0)
  qvel = state.data.qvel.clone()
  qvel[1, 0] = torch.nan
  state = state.replace(data=state.data.replace(qvel=qvel))
  step = NanGuard(env, out_dir=out).wrap(env.step_fn)
  state, (_, _, term, _, extras) = step(state,
                                        torch.zeros(4, env.action_dim))
  return dict(physics_nan=int(extras['Episode_Termination/physics_nan']),
              env1_terminated=bool(term[1]),
              dumps=len(glob.glob(os.path.join(out, 'nan_dump_*.npz'))))


def main():
  with tempfile.TemporaryDirectory() as tmp:
    for name, leg in (('mjlab_tpu', jax_leg), ('mjlab_torch', port_leg)):
      r = leg(os.path.join(tmp, name))
      print(f'{name}: physics_nan {r["physics_nan"]}, env 1 terminated '
            f'{r["env1_terminated"]}, NanGuard dumps {r["dumps"]}',
            flush=True)


if __name__ == '__main__':
  main()
