"""Do the heightfield's downward contacts carry the G1's deepest penetration?

For a sphere below the surface, the neighbouring triangles' edge and corner
candidates of the heightfield collider carry unsigned distances and normals
that point down (away from the surface's outside), and the top-3 keeps
them when they are active: such a contact pushes its geom further into the
terrain. This tool runs `Mjlab-Velocity-Rough-Unitree-G1` under the shipped
G1 flat actor three times from the same start: as the engine is, with
every heightfield candidate whose normal points down dropped (the
heightfield geom is not rotated, so its frame's z is the world's), and as
the engine is again (equal numbers show the run repeats). It prints for
each run: the deepest active heightfield contact, its geom, its normal's z and
its env's downward contacts in that substep; the active downward contacts
and the deepest of them; the active heightfield contacts deeper than 1, 2
and 3 cm (summed over substeps and envs); the resets; env-steps/s.

    python3 tools/hfield_down_normals.py [num_envs] [env_steps] [--device cpu]

Needs one NVIDIA GPU and the CUDA toolkit unless `--device cpu` is given
(the kernels are built on first use). Prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TASK = 'Mjlab-Velocity-Rough-Unitree-G1'
DEPTHS = (0.01, 0.02, 0.03)  # m


@contextlib.contextmanager
def downward_dropped(torch):
  """Within the block the heightfield collider drops every candidate whose
  normal (in the heightfield's frame) points down."""
  from mjlab_torch.physics import collision
  plain = collision._hf_point_candidates

  def no_down(*a, **k):
    dist, pos, normal = plain(*a, **k)
    return torch.where(normal[..., 2] < 0, 1e10, dist), pos, normal

  collision._hf_point_candidates = no_down
  try:
    yield
  finally:
    collision._hf_point_candidates = plain


def run(torch, num_envs: int, steps: int, device: str, drop: bool) -> dict:
  """One run of `steps` env-steps from the task's seeded start."""
  import chip_smoke as cs
  from mjlab_torch.asset_zoo.pretrained import G1_FLAT_POLICY
  from mjlab_torch.physics import pipeline
  from mjlab_torch.rl.networks import load_actor
  from mjlab_torch.tasks import registry

  env = registry.make(TASK, device=device, **{'scene.num_envs': num_envs})
  st = env.model.stat
  g = env.scene.model.geom_quat[st.hfield_geomid]
  assert float((g - g.new_tensor([1.0, 0, 0, 0])).abs().max()) == 0.0
  actor = load_actor(G1_FLAT_POLICY, device=device)
  obs, _ = env.reset()
  ncon = env.state.data.contact.dist.shape[1]
  groups = cs.hfield_groups(st)
  dev = env.device
  deeper = torch.zeros(len(DEPTHS), dtype=torch.long, device=dev)
  resets = torch.zeros((), device=dev)
  with contextlib.ExitStack() as stack:
    rec = stack.enter_context(cs.hfield_recorder(torch, groups, ncon, dev))
    if drop:
      stack.enter_context(downward_dropped(torch))
    recording = pipeline.step
    hf = torch.zeros(ncon, dtype=torch.bool, device=dev)
    for first, n in groups.values():
      hf[first:first + n] = True
    depths = torch.tensor(DEPTHS, device=dev)

    def counting_step(m, d):
      out = recording(m, d)
      c = out.contact
      act = (c.dist < c.includemargin) & hf
      dist = torch.where(act, c.dist, torch.zeros_like(c.dist))
      deeper.add_((dist.reshape(-1, 1) < -depths).sum(0))
      return out

    pipeline.step = counting_step
    try:
      if dev.type == 'cuda':
        torch.cuda.synchronize()
      t0 = time.perf_counter()
      for _ in range(steps):
        obs, _, _, _, extras = env.step(actor(obs))
        resets += extras['reset_count']
      if dev.type == 'cuda':
        torch.cuda.synchronize()
      wall = time.perf_counter() - t0
    finally:
      pipeline.step = recording
  e_at, slot_at = divmod(int(rec['at']), ncon)
  return dict(deepest=float(rec['deepest']),
              geom=st.geom_names[st.con_geom2[slot_at]], env=e_at,
              nz=float(rec['nz_at']), down_in_env=int(rec['down_at']),
              down=int(rec['down']), down_deepest=float(rec['down_deepest']),
              deeper={f'{x:g}': int(v) for x, v in zip(DEPTHS,
                                                        deeper.tolist())},
              resets=int(resets), env_steps_per_s=steps * num_envs / wall)


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__)
  p.add_argument('num_envs', nargs='?', type=int, default=4096)
  p.add_argument('env_steps', nargs='?', type=int, default=150)
  p.add_argument('--device', default='cuda')
  args = p.parse_args(argv)
  import torch
  if args.device == 'cuda':
    if not torch.cuda.is_available():
      sys.exit('hfield_down_normals: needs an NVIDIA GPU (or --device cpu)')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)
  for drop in (False, True, False):
    out = run(torch, args.num_envs, args.env_steps, args.device, drop)
    what = 'downward candidates dropped' if drop else 'the engine as it is'
    down_deepest = (f'{out["down_deepest"]:.5f} m' if out['down']
                    else 'none')
    print(f'{TASK}, {args.num_envs} envs x {args.env_steps} env-steps under '
          f'the shipped flat actor, {what}: deepest active hfield contact '
          f'{out["deepest"]:.5f} m (env {out["env"]}\'s {out["geom"]}, normal '
          f'z {out["nz"]:.5f}, {out["down_in_env"]} downward contacts in its '
          f'env then); active downward contacts {out["down"]}, the deepest '
          f'{down_deepest}; active hfield contacts deeper than '
          f'(m) {out["deeper"]}; resets {out["resets"]}; '
          f'{out["env_steps_per_s"]:.1f} env-steps/s', flush=True)


if __name__ == '__main__':
  main()
