"""The reference's collider faults that the port does not carry over, side
by side: the JAX package, the port and MuJoCo, float64 on the CPU
(ROADMAP.md §3, tests/test_torch_collision_pairs.py).

1. plane-cylinder: a cylinder dropped upright (and one tilted 3 degrees)
   onto a plane, 400 steps of each engine; prints the height and the tilt
   at steps 100 and 400.
2. sphere-cylinder with the sphere's centre inside the cylinder: one
   placement's contact in each engine.
3. the convex core's deep test in float32: 2,048 seeded overlapping
   placements of three pairs; prints how many float32 normals of each
   package lie more than 1e-3 from the port's float64 normal.

    python tools/collider_faults.py    # about 2 minutes
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ['JAX_PLATFORMS'] = 'cpu'

import jax  # noqa: E402

jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)

import jax.numpy as jnp  # noqa: E402
import mujoco  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mjlab_tpu.physics import collision as jcol  # noqa: E402
from mjlab_tpu.physics import io as jio  # noqa: E402
from mjlab_tpu.physics import pipeline as jpipe  # noqa: E402
import mjlab_torch.physics as tphys  # noqa: E402
from mjlab_torch.physics import collision as tcol  # noqa: E402
from mjlab_torch.physics.types import GeomType  # noqa: E402

CYLINDER_XML = """
<mujoco>
  <option timestep="0.002" iterations="30" ls_iterations="50"/>
  <worldbody>
    <geom type="plane" size="5 5 .1"/>
    <body pos="0 0 0.105" euler="{tilt} 0 0"><freejoint/>
      <geom type="cylinder" size="0.07 0.1" mass="0.2"/>
    </body>
  </worldbody>
</mujoco>"""


def tilt_deg(q) -> float:
  x, y = q[4], q[5]
  return float(np.degrees(np.arccos(np.clip(1 - 2 * (x * x + y * y), -1,
                                            1))))


def cylinder_rest() -> None:
  for tilt in (0.0, 3.0):
    mj = mujoco.MjModel.from_xml_string(CYLINDER_XML.format(tilt=tilt))
    mj.opt.solver = mujoco.mjtSolver.mjSOL_NEWTON
    md = mujoco.MjData(mj)
    jm = jio.put_model(mj, dtype=jnp.float64)
    jd = jio.make_data(jm, dtype=jnp.float64)
    jstep = jax.jit(lambda d: jpipe.step(jm, d))
    tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
    td = tphys.make_batched_data(tm, 1, device='cpu')
    for i in range(400):
      jd = jstep(jd)
      td = tphys.step(tm, td)
      mujoco.mj_step(mj, md)
      if i in (99, 399):
        rows = {'JAX': np.asarray(jd.qpos), 'port': td.qpos[0].numpy(),
                'MuJoCo': md.qpos}
        print(f'cylinder from {tilt} degrees, step {i + 1}: ' + ', '.join(
            f'{k} z {q[2]:.6f} m tilt {tilt_deg(q):.4f} deg'
            for k, q in rows.items()), flush=True)


def sphere_inside() -> None:
  mj = mujoco.MjModel.from_xml_string("""
<mujoco>
  <worldbody>
    <body><geom type="cylinder" size="0.07 0.1"/></body>
    <body pos="0.02 0 0.03"><freejoint/><geom type="sphere" size="0.08"/></body>
  </worldbody>
</mujoco>""")
  md = mujoco.MjData(mj)
  mujoco.mj_forward(mj, md)
  c = md.contact[0]
  args = [md.geom_xpos[1], md.geom_xmat[1].reshape(3, 3), mj.geom_size[1],
          md.geom_xpos[0], md.geom_xmat[0].reshape(3, 3), mj.geom_size[0]]
  key = (GeomType.SPHERE, GeomType.CYLINDER)
  j = jcol._COLLIDERS[key](*[jnp.asarray(a)[None] for a in args])
  t = [torch.as_tensor(a)[None] for a in args]
  p = tcol._COLLIDERS[key](t[0][None], t[1][None], t[2], t[3][None],
                           t[4][None], t[5])
  print(f'sphere centre 0.02 m off a cylinder\'s axis: MuJoCo dist '
        f'{c.dist:.6f} normal {np.round(c.frame[:3], 6)}; JAX '
        f'{float(j[0][0, 0]):.6f} {np.round(np.asarray(j[2][0, 0]), 6)}; '
        f'port {float(p[0][0, 0, 0]):.6f} '
        f'{np.round(p[2][0, 0, 0].numpy(), 6)}', flush=True)


def float32_deep() -> None:
  sizes = {GeomType.ELLIPSOID: [0.1, 0.07, 0.05],
           GeomType.CYLINDER: [0.07, 0.1, 0.0], GeomType.BOX: [0.08, 0.06,
                                                             0.05]}
  n = 2048
  for key in ((GeomType.ELLIPSOID, GeomType.ELLIPSOID),
              (GeomType.CYLINDER, GeomType.BOX),
              (GeomType.ELLIPSOID, GeomType.CYLINDER)):
    rng = np.random.default_rng(1)
    rot = lambda: np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    args = [np.zeros((n, 3)), rot(), np.tile(sizes[key[0]], (n, 1)),
            rng.uniform(0.0, 0.12, (n, 1)) * rng.normal(size=(n, 3)), rot(),
            np.tile(sizes[key[1]], (n, 1))]
    normals = {}
    for dt in (np.float64, np.float32):
      j = jcol._COLLIDERS[key](*[jnp.asarray(a.astype(dt)) for a in args])
      t = [torch.as_tensor(a.astype(dt)) for a in args]
      p = tcol._COLLIDERS[key](t[0][None], t[1][None], t[2], t[3][None],
                               t[4][None], t[5])
      normals[('JAX', dt)] = np.asarray(j[2])
      normals[('port', dt)] = p[2][0].numpy()
    ref = normals[('port', np.float64)]
    bad = {k[0]: int((np.abs(v - ref).max((-1, -2)) > 1e-3).sum())
           for k, v in normals.items() if k[1] == np.float32}
    print(f'{GeomType(key[0]).name.lower()}-{GeomType(key[1]).name.lower()}'
          f': float32 normals more than 1e-3 off the float64 ones, of {n}: '
          f'{bad}', flush=True)


if __name__ == '__main__':
  torch.set_num_threads(1)
  sphere_inside()
  float32_deep()
  cylinder_rest()
