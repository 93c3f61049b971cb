"""Parity of the port's analytic and convex-solid colliders with the JAX
package, float64 on the CPU: plane-ellipsoid, plane-cylinder,
sphere-ellipsoid, sphere-cylinder and the seven pairs of the erosion and
alternating-projection core (capsule-{ellipsoid,cylinder},
ellipsoid-{ellipsoid,cylinder,box}, cylinder-{cylinder,box}).

Each pair is placed as tests/test_collision_pairs.py places it (its
`zlib.crc32`-seeded near-touch trials, 24 a pair), plus separated and
deep-overlap placements, and every placement of a pair goes through the
JAX collider and the port's in one batched call: dist, pos and the contact
frame agree within 1e-9. The near-touch placements are also held against
mujoco.mj_forward at the JAX tests' own tolerances (8e-3 on the distance,
0.9 on the normal's alignment).

Two colliders of the reference are not carried over (ROADMAP.md §3), each
with its test here: plane-cylinder's near-cap points, and sphere-cylinder
with the sphere's centre inside the cylinder; a third test holds the
convex core's deep-overlap test in float32. The JAX package's
test_pair_settles_on_floor is ported with the rollout held to the JAX
step."""

import zlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import collision as jcol
from mjlab_tpu.physics import math as jmath
from mjlab_tpu.physics import pipeline as jpipe
import mjlab_torch.physics as tphys
from mjlab_torch.physics import collision as tcol
from mjlab_torch.physics import math as tmath
from mjlab_torch.physics.types import GeomType
from torch_parity import assert_close, oracle_pair, quick_jit

TOL = 1e-9
ROLLOUT_TOL = 1e-8

GEOM_XML = {
    'sphere': '<geom type="sphere" size="0.08" mass="0.2"/>',
    'capsule': '<geom type="capsule" size="0.05 0.12" mass="0.2"/>',
    'ellipsoid': '<geom type="ellipsoid" size="0.1 0.07 0.05" mass="0.2"/>',
    'cylinder': '<geom type="cylinder" size="0.07 0.1" mass="0.2"/>',
    'box': '<geom type="box" size="0.08 0.06 0.05" mass="0.2"/>',
}
TYPE = {'plane': GeomType.PLANE, 'sphere': GeomType.SPHERE,
        'capsule': GeomType.CAPSULE, 'ellipsoid': GeomType.ELLIPSOID,
        'cylinder': GeomType.CYLINDER, 'box': GeomType.BOX}

# the pairs of tests/test_collision_pairs.py, then the analytic ones
PAIRS = [
    ('sphere', 'ellipsoid'), ('capsule', 'ellipsoid'),
    ('capsule', 'cylinder'), ('ellipsoid', 'ellipsoid'),
    ('ellipsoid', 'cylinder'), ('ellipsoid', 'box'),
    ('cylinder', 'cylinder'), ('cylinder', 'box'),
    ('plane', 'ellipsoid'), ('plane', 'cylinder'), ('sphere', 'cylinder'),
]
NEAR = 24  # near-touch trials a pair, as the JAX test
SEPARATED = 4
DEEP = 6


def scene(t1, t2, pos2, euler2, margin=None):
  """t1 fixed at the origin (a plane: the world's floor), t2 free at pos2
  and euler2 (degrees); `margin` on both geoms."""
  add = f' margin="{margin}"' if margin is not None else ''
  g2 = GEOM_XML[t2].replace('/>', add + '/>')
  if t1 == 'plane':
    g1 = f'<geom type="plane" size="5 5 0.1"{add}/>'
  else:
    g1 = ('<body name="b0" pos="0 0 0">'
          + GEOM_XML[t1].replace('/>', add + '/>') + '</body>')
  return mujoco.MjModel.from_xml_string(f"""
<mujoco>
  <worldbody>
    {g1}
    <body name="b1" pos="{pos2[0]} {pos2[1]} {pos2[2]}"
          euler="{euler2[0]} {euler2[1]} {euler2[2]}">
      <freejoint/>
      {g2}
    </body>
  </worldbody>
</mujoco>""")


def placements(t1, t2):
  """[(pos2, euler2, kind)]: the JAX test's near-touch trials (its seed and
  draws), then separated and deep-overlap ones from the same stream. A
  plane pair puts the solid at heights around its extent instead."""
  rng = np.random.default_rng(zlib.crc32(f'{t1}-{t2}'.encode()))
  out = []
  for i in range(NEAR + SEPARATED + DEEP):
    dirn = rng.normal(size=3)
    dirn /= np.linalg.norm(dirn)
    if t1 == 'plane':
      kind = 'near' if i < NEAR else 'separated' if i < NEAR + SEPARATED \
          else 'deep'
      z = (rng.uniform(0.02, 0.13) if kind == 'near' else 0.4
           if kind == 'separated' else rng.uniform(-0.05, 0.02))
      out.append((np.array([dirn[0], dirn[1], 0.0]) * 0.1 + [0, 0, z],
                  rng.uniform(-90, 90, 3), kind))
      continue
    if i < NEAR:
      kind, dist = 'near', rng.uniform(0.10, 0.18)
    elif i < NEAR + SEPARATED:
      kind, dist = 'separated', 0.45
    else:
      kind, dist = 'deep', rng.uniform(0.0, 0.05)
    out.append((dirn * dist, rng.uniform(-40, 40, 3), kind))
  return out


def mj_deepest(mj):
  """(dist, normal) of MuJoCo's deepest contact, or None."""
  md = mujoco.MjData(mj)
  mujoco.mj_forward(mj, md)
  if md.ncon == 0:
    return None
  i = min(range(md.ncon), key=lambda i: md.contact[i].dist)
  return float(md.contact[i].dist), md.contact[i].frame[:3].copy()


def batch(t1, t2):
  """The poses and sizes of every placement of the pair, stacked
  (p1, m1, s1, p2, m2, s2), the kinds, MuJoCo's deepest contacts."""
  poses, kinds, oracle = [], [], []
  for pos2, euler2, kind in placements(t1, t2):
    mj = scene(t1, t2, pos2, euler2)
    md = mujoco.MjData(mj)
    mujoco.mj_kinematics(mj, md)
    poses.append((md.geom_xpos[0].copy(), md.geom_xmat[0].reshape(3, 3),
                  mj.geom_size[0].copy(), md.geom_xpos[1].copy(),
                  md.geom_xmat[1].reshape(3, 3), mj.geom_size[1].copy()))
    kinds.append(kind)
    oracle.append(mj_deepest(mj) if kind == 'near' else None)
  return [np.stack(x) for x in zip(*poses)], np.asarray(kinds), oracle


def both(fn_jax, fn_port, args, dtype=np.float64):
  """(JAX's, port's) (dist, pos, normal) of the stacked args, (n, k, ...)
  numpy each; the port's colliders take a leading env axis (one env)."""
  j = fn_jax(*[jnp.asarray(a.astype(dtype)) for a in args])
  t = [torch.as_tensor(a.astype(dtype)) for a in args]
  p = fn_port(t[0][None], t[1][None], t[2], t[3][None], t[4][None], t[5])
  return ([np.asarray(x) for x in j[:3]], [x[0].numpy() for x in p[:3]])


def frames(jout, pout):
  return (np.asarray(jmath.make_tangent_frame(jnp.asarray(jout[2]))),
          tmath.make_tangent_frame(torch.as_tensor(pout[2])).numpy())


def sphere_centre_inside(args):
  """Placements whose sphere centre lies inside the cylinder."""
  p1, _, _, p2, m2, s2 = args
  rel = np.einsum('nji,nj->ni', m2, p1 - p2)
  return ((np.linalg.norm(rel[:, :2], axis=-1) < s2[:, 0])
          & (np.abs(rel[:, 2]) < s2[:, 1]))


@pytest.mark.parametrize('t1,t2', PAIRS)
def test_pair_matches_jax_and_mujoco(t1, t2):
  """Every placement through both colliders in one call each: dist, pos
  and frame within 1e-9 of the JAX collider; the near-touch ones against
  MuJoCo as the JAX test holds its engine. Not compared with the JAX
  collider, by design (see the tests below): plane-cylinder's slots 1 and
  2, and sphere-cylinder where the sphere's centre is inside."""
  key = (TYPE[t1], TYPE[t2])
  args, kinds, oracle = batch(t1, t2)
  jout, pout = both(jcol._COLLIDERS[key], tcol._COLLIDERS[key], args)
  keep = np.ones(jout[0].shape, bool)
  if key == (GeomType.PLANE, GeomType.CYLINDER):
    keep[:, 1:3] = False
  if key == (GeomType.SPHERE, GeomType.CYLINDER):
    inside = sphere_centre_inside(args)
    assert inside.any() and (kinds[inside] == 'deep').all()
    keep[inside] = False
  for name, j, p in zip(('dist', 'pos', 'frame'), (*jout[:2], None),
                        (*pout[:2], None)):
    if name == 'frame':
      j, p = frames(jout, pout)
    assert_close(p[keep], j[keep], TOL, f'{t1}-{t2} {name}')
  assert (pout[0][kinds == 'separated'] > 0.05).all()
  assert (pout[0][kinds == 'deep'].min(-1) < -0.02).all()
  checked = 0
  for i, c in enumerate(oracle):
    if c is None or c[0] > 0.0 or c[0] < -0.02:
      continue
    k = int(np.argmin(pout[0][i]))
    assert pout[0][i, k] < 0.003, (t1, t2, i, pout[0][i, k], c[0])
    assert abs(pout[0][i, k] - c[0]) < 8e-3, (t1, t2, i, pout[0][i, k], c[0])
    assert abs(float(pout[2][i, k] @ c[1])) > 0.9, (t1, t2, i)
    checked += 1
  assert checked >= 3, f'too few contact configurations sampled ({checked})'


def test_plane_cylinder_is_mujocos():
  """Fault of the reference, not carried over. Its plane-cylinder puts the
  three near-cap points at the deepest rim point and +-45 degrees from it
  (all on one side of the cap), or, with the cap parallel to the plane,
  all three at the cap's centre: a cylinder on its cap has no support on
  the other side. The port takes MuJoCo's set (the deepest rim point, the
  other two corners of the equilateral triangle in that cap, the far cap's
  rim point): with every contact reported (margin 1), each of MuJoCo's
  contacts is one of the port's four within 1e-12, in slot order, the
  cap parallel to the plane included; slots 0 and 3 are the reference's."""
  key = (GeomType.PLANE, GeomType.CYLINDER)
  for euler in ('20 10 5', '0 0 0', '180 0 0', '95 0 30', '-30 60 10'):
    mj = scene('plane', 'cylinder', (0.1, 0.2, 0.15), euler.split(),
               margin=1.0)
    md = mujoco.MjData(mj)
    mujoco.mj_forward(mj, md)
    assert md.ncon == 4
    args = [md.geom_xpos[0], md.geom_xmat[0].reshape(3, 3), mj.geom_size[0],
            md.geom_xpos[1], md.geom_xmat[1].reshape(3, 3), mj.geom_size[1]]
    jout, pout = both(jcol._COLLIDERS[key], tcol._COLLIDERS[key],
                      [np.asarray(a)[None] for a in args])
    # MuJoCo's order: near rim, far rim, the triangle's two corners
    for slot, c in zip((0, 3, 1, 2), md.contact[:4]):
      assert abs(pout[0][0, slot] - c.dist) < 1e-12, (euler, slot)
      assert_close(pout[1][0, slot], c.pos, 1e-12, f'{euler} slot {slot}')
      assert_close(pout[2][0, slot], c.frame[:3], 1e-12, euler)
    assert_close(pout[0][0, [0, 3]], jout[0][0, [0, 3]], TOL, euler)
    if euler == '0 0 0':  # the reference's three near-cap points coincide
      assert np.abs(jout[1][0, 1] - jout[1][0, 2]).max() < 1e-12
      assert np.abs(pout[1][0, 1] - pout[1][0, 2]).max() > 0.1


def test_cylinder_rests_on_its_cap_as_in_mujoco():
  """A cylinder dropped upright (and one tilted 3 degrees) onto a plane:
  the port's 100-step rollout stays within 1e-7 of mj_step, three contacts
  a step as MuJoCo's, while the reference's one-sided contacts leave the
  JAX engine's cylinder tilted and ~0.56 mm deeper (0.099294 m against
  MuJoCo's 0.099858 after 400 steps, tools/collider_faults.py)."""
  xml = """
<mujoco>
  <option timestep="0.002" iterations="30" ls_iterations="50"/>
  <worldbody>
    <geom type="plane" size="5 5 .1"/>
    <body pos="0 0 0.105"><freejoint/>
      <geom type="cylinder" size="0.07 0.1" mass="0.2"/>
    </body>
  </worldbody>
</mujoco>"""
  mj = mujoco.MjModel.from_xml_string(xml)
  mj.opt.solver = mujoco.mjtSolver.mjSOL_NEWTON
  tilt = np.deg2rad(3.0)
  qpos = np.tile(mj.qpos0, (2, 1))
  qpos[1, 3:7] = [np.cos(tilt / 2), np.sin(tilt / 2), 0.0, 0.0]
  mds = [mujoco.MjData(mj) for _ in range(2)]
  for md, q in zip(mds, qpos):
    md.qpos[:] = q
  jm, jd, tm, td = oracle_pair(mj, qpos, np.zeros((2, mj.nv)))
  step = quick_jit(jax.vmap(jpipe.step, in_axes=(None, 0)))
  for _ in range(100):
    td = tphys.step(tm, td)
    jd = step(jm, jd)
    for md in mds:
      mujoco.mj_step(mj, md)
  for e, md in enumerate(mds):
    assert_close(td.qpos[e], md.qpos, 1e-7, f'env {e} qpos against MuJoCo')
    assert int(td.ncon_active[e]) == md.ncon == 3
  assert float(np.abs(np.asarray(jd.qpos)[:, 2] - td.qpos[:, 2].numpy()).max()
               ) > 1e-4


def test_sphere_centre_inside_cylinder_is_mujocos():
  """Fault of the reference, not carried over. Its sphere-cylinder clamps
  the centre to the solid cylinder; a centre inside clamps to itself, so
  the depth is the sphere's radius and the normal world -z whatever the
  overlap. The port leaves through the nearest surface, side or cap, as
  MuJoCo: dist, pos and normal within 1e-12 of mj_forward's contact, on
  the axis and off it, near the side and near a cap; outside the
  cylinder both packages agree with MuJoCo."""
  key = (GeomType.SPHERE, GeomType.CYLINDER)
  cases = [((0.02, 0.0, 0.03), True), ((0.0, 0.0, 0.0), True),
           ((0.05, 0.01, 0.0), True), ((0.01, 0.0, 0.09), True),
           ((-0.03, 0.02, -0.07), True), ((0.12, 0.02, 0.0), False),
           ((0.1, 0.0, 0.15), False)]
  for pos, inside in cases:
    mj = mujoco.MjModel.from_xml_string(f"""
<mujoco>
  <worldbody>
    <body euler="10 20 30"><geom type="cylinder" size="0.07 0.1"/></body>
    <body pos="{pos[0]} {pos[1]} {pos[2]}"><freejoint/>
      <geom type="sphere" size="0.08"/></body>
  </worldbody>
</mujoco>""")
    md = mujoco.MjData(mj)
    mujoco.mj_forward(mj, md)
    assert md.ncon == 1
    c = md.contact[0]
    # MuJoCo's geom1 is the sphere here, as the port's
    assert (c.geom1, c.geom2) == (1, 0)
    args = [md.geom_xpos[1], md.geom_xmat[1].reshape(3, 3), mj.geom_size[1],
            md.geom_xpos[0], md.geom_xmat[0].reshape(3, 3), mj.geom_size[0]]
    jout, pout = both(jcol._COLLIDERS[key], tcol._COLLIDERS[key],
                      [np.asarray(a)[None] for a in args])
    assert abs(pout[0][0, 0] - c.dist) < 1e-12, pos
    if pos == (0.0, 0.0, 0.0):
      assert abs(pout[2][0, 0] @ md.geom_xmat[0].reshape(3, 3)[:, 2]) < 1e-12
    else:
      assert_close(pout[1][0, 0], c.pos, 1e-12, f'{pos} pos')
      assert_close(pout[2][0, 0], c.frame[:3], 1e-12, f'{pos} normal')
    if inside:
      assert abs(jout[0][0, 0] + 0.08) < 1e-12  # the reference: -r
      assert_close(jout[2][0, 0], [0.0, 0.0, -1.0], 1e-12, 'reference')
    else:
      assert abs(jout[0][0, 0] - c.dist) < 1e-12


@pytest.mark.parametrize('key', [
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID),
    (GeomType.ELLIPSOID, GeomType.CYLINDER),
    (GeomType.CYLINDER, GeomType.BOX),
    (GeomType.CAPSULE, GeomType.ELLIPSOID)])
def test_deep_overlap_keeps_its_normal_in_float32(key):
  """Fault of the reference in float32, not carried over. Its convex core
  calls an overlap deep when a point's distance to its projection onto
  the other eroded solid is below 1e-9; in float32 the frame's rounding
  leaves ~1e-8 there, the overlap reads as separated and the normal is
  the direction between two coincident points. On 512 seeded overlapping
  placements the port, which adds the projections' own inside tests,
  keeps its float32 normals within 1e-3 of its float64 ones on all but a
  few near the deep/shallow switch (where float64's branch itself turns
  on a sliver of overlap); the reference's float32 normals fail on over
  three times as many. In float64 both decide alike: the distances within
  1e-9, the normals within 1e-6 (a normal between two nearly touching
  eroded solids amplifies the last bits of the frame)."""
  rng = np.random.default_rng(7)
  n = 512
  sizes = {GeomType.ELLIPSOID: [0.1, 0.07, 0.05],
           GeomType.CYLINDER: [0.07, 0.1, 0.0],
           GeomType.BOX: [0.08, 0.06, 0.05],
           GeomType.CAPSULE: [0.05, 0.12, 0.0]}
  rot = lambda: np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
  args = [np.zeros((n, 3)), rot(), np.tile(sizes[key[0]], (n, 1)),
          rng.uniform(0.0, 0.1, (n, 1)) * rng.normal(size=(n, 3)), rot(),
          np.tile(sizes[key[1]], (n, 1))]
  j64, p64 = both(jcol._COLLIDERS[key], tcol._COLLIDERS[key], args)
  assert_close(p64[0], j64[0], TOL, 'float64 dist')
  assert_close(p64[2], j64[2], 1e-6, 'float64 normal')
  j32, p32 = both(jcol._COLLIDERS[key], tcol._COLLIDERS[key], args,
                  np.float32)
  bad = lambda out: int((np.abs(out[2] - p64[2]).max((-1, -2)) > 1e-3).sum())
  assert bad(p32) <= n // 25, bad(p32)
  assert bad(j32) > 3 * max(bad(p32), 1), (bad(j32), bad(p32))


@pytest.mark.parametrize('t2', ['ellipsoid', 'cylinder'])
def test_pair_settles_on_floor(t2):
  """tests/test_collision_pairs.py's dynamic check, ported: the solid
  dropped onto a box floor settles finitely, through the convex pairs
  inside the whole step; the port's rollout is the JAX engine's within
  1e-8 on qpos and qvel. The model is the JAX test's, solved with the
  oracle models' Newton settings (30 iterations, 50 linesearch
  iterations) in both engines, over 150 steps (0.75 s, the last 0.5 s on
  the floor) where the JAX test takes 250: both cuts keep the port's CPU
  rollout inside the test's time."""
  xml = f"""
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <body name="floor">
      <geom name="floorg" type="box" size="1 1 0.1" pos="0 0 -0.1"/>
    </body>
    <body name="b" pos="0.02 0.01 0.3" euler="20 15 5">
      <freejoint/>
      {GEOM_XML[t2]}
    </body>
  </worldbody>
</mujoco>"""
  from mjlab_torch.asset_zoo.oracle_models import compile_model
  mj = compile_model(xml)
  qpos = mj.qpos0[None].copy()
  jm, jd, tm, td = oracle_pair(mj, qpos, np.zeros((1, mj.nv)))
  step = quick_jit(jax.vmap(jpipe.step, in_axes=(None, 0)))
  for _ in range(150):
    td = tphys.step(tm, td)
    jd = step(jm, jd)
  assert_close(td.qpos, jd.qpos, ROLLOUT_TOL, 'qpos')
  assert_close(td.qvel, jd.qvel, ROLLOUT_TOL, 'qvel')
  assert bool(torch.isfinite(td.qpos).all())
  z = float(td.qpos[0, 2])
  assert 0.0 < z < 0.2, z
