"""Parity of the port's mesh narrowphase with the JAX package, float64 on
the CPU: the convex hulls (mjlab_torch/physics/mesh.py) bit for bit; the
seven mesh pair groups (plane, sphere, capsule, ellipsoid, cylinder, box
and mesh against the octahedron of tests/test_mesh_collision.py) on that
test's seeded near-touch placements plus separated and deep ones, within
1e-9 of the JAX colliders and at the JAX test's MuJoCo tolerances (8e-3,
0.85); the `mesh_drop` model's 200-step rollout against the JAX step and
mj_step; and the `convex_pile` model's collision, all 24 groups, against
the JAX collision on seeded states."""

import zlib

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import collision as jcol
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import kinematics as jkin
from mjlab_tpu.physics import math as jmath
from mjlab_tpu.physics import mesh as jmesh
from mjlab_tpu.physics import pipeline as jpipe
import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import oracle_models as om
from mjlab_torch.physics import collision as tcol
from mjlab_torch.physics import io as tio
from mjlab_torch.physics import kinematics as tkin
from mjlab_torch.physics import math as tmath
from mjlab_torch.physics import mesh as tmesh
from mjlab_torch.physics.types import GeomType
from torch_parity import assert_close, oracle_pair, quick_jit

TOL = 1e-9
ROLLOUT_TOL = 1e-8

GEOM_XML = {
    'plane': '<geom type="plane" size="5 5 0.1"/>',
    'sphere': '<geom type="sphere" size="0.08" mass="0.2"/>',
    'capsule': '<geom type="capsule" size="0.05 0.12" mass="0.2"/>',
    'ellipsoid': '<geom type="ellipsoid" size="0.1 0.07 0.05" mass="0.2"/>',
    'cylinder': '<geom type="cylinder" size="0.07 0.1" mass="0.2"/>',
    'box': '<geom type="box" size="0.08 0.06 0.05" mass="0.2"/>',
    'mesh': '<geom type="mesh" mesh="octa" mass="0.2"/>',
    'mesh2': '<geom type="mesh" mesh="gem" mass="0.2"/>',
}
TYPE = {'plane': GeomType.PLANE, 'sphere': GeomType.SPHERE,
        'capsule': GeomType.CAPSULE, 'ellipsoid': GeomType.ELLIPSOID,
        'cylinder': GeomType.CYLINDER, 'box': GeomType.BOX,
        'mesh2': GeomType.MESH}
PARTNERS = ['sphere', 'capsule', 'ellipsoid', 'cylinder', 'box', 'mesh2',
            'plane']
NEAR, SEPARATED, DEEP = 24, 4, 6


def scene(t1, pos2, euler2, mesh_attrs=''):
  """t1 at the origin (a plane: the floor), the octahedron free at pos2
  and euler2 (degrees); both meshes declared (tests/test_mesh_collision.py)."""
  g1 = GEOM_XML[t1] if t1 == 'plane' else (
      f'<body name="b0" pos="0 0 0">{GEOM_XML[t1]}</body>')
  return mujoco.MjModel.from_xml_string(f"""
<mujoco>
  <asset>
    <mesh name="octa" vertex="{om.OCTA}"/>
    <mesh name="gem" vertex="{om.GEM}"/>
  </asset>
  <worldbody>
    {g1}
    <body name="b1" pos="{pos2[0]} {pos2[1]} {pos2[2]}"
          euler="{euler2[0]} {euler2[1]} {euler2[2]}">
      <freejoint/>
      {GEOM_XML['mesh'].replace('/>', mesh_attrs + '/>')}
    </body>
  </worldbody>
</mujoco>""")


def _hulls_equal(a, b):
  assert a is not None and b is not None
  for k in tmesh.MeshHulls._fields:
    x, y = getattr(a, k), getattr(b, k)
    assert x.dtype == y.dtype and x.shape == y.shape, k
    assert np.array_equal(x, y), k


def test_hulls_are_the_references():
  """The port's hulls equal mjlab_tpu.physics.mesh.build_hulls's bit for
  bit, from the MjModel, from its ModelArrays snapshot and through
  put_model. The gem is declared but no geom carries it: its row is
  skipped (zero masks, inradius 0), as a visual-only mesh's."""
  mj = scene('sphere', (1, 0, 0), (0, 0, 0))
  want = jmesh.build_hulls(mj)
  _hulls_equal(tmesh.build_hulls(mj), want)
  snap = tio.ModelArrays.of(mj)
  assert set(tio.MESH_ARRAYS) <= set(snap.arrays())
  _hulls_equal(tmesh.build_hulls(snap), want)
  s = tphys.put_model(snap, device='cpu').stat
  _hulls_equal(s.mesh_hulls, want)
  assert s.geom_dataid.tolist() == mj.geom_dataid.tolist()
  octa = int(mj.geom_dataid[1])
  assert want.rin[1 - octa] == 0 and want.vmask[1 - octa].sum() == 0
  assert int(want.vmask[octa].sum()) == 6 and int(want.fmask[octa].sum()) == 8
  # both meshes carried by colliding geoms: both rows built
  mj2 = scene('mesh2', (1, 0, 0), (0, 0, 0))
  _hulls_equal(tmesh.build_hulls(tio.ModelArrays.of(mj2)),
               jmesh.build_hulls(mj2))
  assert (tmesh.build_hulls(mj2).rin > 0).all()


def test_visual_only_meshes_are_skipped():
  """A model whose meshes only visual geoms (contype = conaffinity = 0)
  carry: the reference builds every row empty, the port keeps no mesh
  tables at all (no hulls, no mesh geom ids), and its snapshot carries no
  mesh arrays and builds the same static tables as its compile."""
  mj = scene('sphere', (1, 0, 0), (0, 0, 0),
             ' contype="0" conaffinity="0"')
  want = jio.put_model(mj, dtype=jnp.float64).stat
  assert want.mesh_hulls.vmask.sum() == 0 and want.mesh_hulls.fmask.sum() == 0
  assert tmesh.collidable_meshes(mj) == set()
  assert tmesh.build_hulls(mj) is None
  snap = tio.ModelArrays.of(mj)
  assert not set(tio.MESH_ARRAYS) & set(snap.arrays())
  a = tphys.put_model(mj, device='cpu').stat
  assert a == tphys.put_model(snap, device='cpu').stat
  assert a.mesh_hulls is None and (a.geom_dataid == -1).all()


def placements(t1):
  """The JAX test's near-touch trials (its seed and draws), then separated
  and deep ones from the same stream; the plane puts the octahedron at
  heights around its extent."""
  rng = np.random.default_rng(zlib.crc32(f'{t1}-mesh'.encode()))
  out = []
  for i in range(NEAR + SEPARATED + DEEP):
    kind = 'near' if i < NEAR else 'separated' if i < NEAR + SEPARATED \
        else 'deep'
    dirn = rng.normal(size=3)
    dirn /= np.linalg.norm(dirn)
    if t1 == 'plane':
      z = (rng.uniform(0.0, 0.1) if kind == 'near' else 0.4
           if kind == 'separated' else rng.uniform(-0.04, 0.0))
      out.append((np.array([dirn[0], dirn[1], 0.0]) * 0.1 + [0, 0, z],
                  rng.uniform(-90, 90, 3), kind))
      continue
    dist = (rng.uniform(0.08, 0.16) if kind == 'near' else 0.45
            if kind == 'separated' else rng.uniform(0.0, 0.04))
    out.append((dirn * dist, rng.uniform(-40, 40, 3), kind))
  return out


def mj_deepest(mj):
  md = mujoco.MjData(mj)
  mujoco.mj_forward(mj, md)
  if md.ncon == 0:
    return None
  i = min(range(md.ncon), key=lambda i: md.contact[i].dist)
  return float(md.contact[i].dist), md.contact[i].frame[:3].copy()


@pytest.mark.parametrize('t1', PARTNERS)
def test_mesh_pair_matches_jax_and_mujoco(t1):
  """Every placement through the JAX mesh collider and the port's in one
  call each (the hulls gathered for the batch's pairs): dist, pos and
  frame within 1e-9; the near-touch ones against MuJoCo at the JAX test's
  tolerances. Ties: plane-mesh sorts its vertices stably, hull support and
  projection take the first vertex or face on a tie, as jnp.argsort,
  jnp.argmax and jnp.argmin do."""
  key = (TYPE[t1], GeomType.MESH)
  poses, kinds, oracle = [], [], []
  for pos2, euler2, kind in placements(t1):
    mj = scene(t1, pos2, euler2)
    md = mujoco.MjData(mj)
    mujoco.mj_kinematics(mj, md)
    poses.append((md.geom_xpos[0].copy(), md.geom_xmat[0].reshape(3, 3),
                  md.geom_xpos[1].copy(), md.geom_xmat[1].reshape(3, 3)))
    kinds.append(kind)
    oracle.append(mj_deepest(mj) if kind == 'near' else None)
  p1, m1, p2, m2 = (np.stack(x) for x in zip(*poses))
  kinds = np.asarray(kinds)
  n = len(kinds)
  g1s, g2s = np.zeros(n, np.int32), np.ones(n, np.int32)
  fn, s1, s2 = jcol._mesh_collider(jio.put_model(mj, dtype=jnp.float64), key,
                                   g1s, g2s)
  j = [np.asarray(x) for x in fn(jnp.asarray(p1), jnp.asarray(m1), s1,
                                  jnp.asarray(p2), jnp.asarray(m2), s2)]
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  fn, s1, s2 = tcol._mesh_collider(tm, key, g1s, g2s)
  t = lambda x: torch.as_tensor(x)[None]
  p = [x[0].numpy() for x in fn(t(p1), t(m1), s1, t(p2), t(m2), s2)]
  assert_close(p[0], j[0], TOL, f'{t1} dist')
  assert_close(p[1], j[1], TOL, f'{t1} pos')
  assert_close(tmath.make_tangent_frame(torch.as_tensor(p[2])),
               jmath.make_tangent_frame(jnp.asarray(j[2])), TOL,
               f'{t1} frame')
  assert (p[0][kinds == 'separated'] > 0.05).all()
  assert (p[0][kinds == 'deep'].min(-1) < 0.0).all()
  checked = 0
  for i, c in enumerate(oracle):
    if c is None or c[0] > 0.0 or c[0] < -0.02:
      continue
    k = int(np.argmin(p[0][i]))
    assert p[0][i, k] < 0.003, (t1, i, p[0][i, k], c[0])
    assert abs(p[0][i, k] - c[0]) < 8e-3, (t1, i, p[0][i, k], c[0])
    # flat-flat configurations have ambiguous normals (the JAX test's
    # looser alignment)
    assert abs(float(p[2][i, k] @ c[1])) > 0.85, (t1, i)
    checked += 1
  assert checked >= 3, f'too few contact configurations sampled ({checked})'


def test_mesh_drop_rollout_matches_jax_and_mujoco():
  """The `mesh_drop` model (test_mesh_plane_rollout_oracle's octahedron
  on a plane), 200 steps: the port's rollout is the JAX engine's within
  1e-8 on qpos and qvel, and tracks mj_step as the JAX test holds its
  engine (1e-6 before contact, the same rest height within 2e-3 and as
  many contacts)."""
  mj = om.oracle_model('mesh_drop')
  md = mujoco.MjData(mj)
  jm, jd, tm, td = oracle_pair(mj, mj.qpos0[None].copy(),
                               np.zeros((1, mj.nv)))
  step = quick_jit(jax.vmap(jpipe.step, in_axes=(None, 0)))
  for i in range(200):
    td = tphys.step(tm, td)
    jd = step(jm, jd)
    mujoco.mj_step(mj, md)
    if i == 99:
      assert_close(td.qpos[0], md.qpos, 1e-6, 'qpos against MuJoCo')
  assert_close(td.qpos, jd.qpos, ROLLOUT_TOL, 'qpos')
  assert_close(td.qvel, jd.qvel, ROLLOUT_TOL, 'qvel')
  assert bool(torch.isfinite(td.qpos).all())
  assert abs(float(td.qpos[0, 2]) - md.qpos[2]) < 2e-3
  assert int(td.ncon_active[0]) == md.ncon


def pile_states(mj, n, seed):
  """n seeded states of the pile, its bodies drawn toward each other and
  the floor from the compiled layout, in random orientations."""
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (n, 1))
  for b in range(9):
    pos = qpos[:, 7 * b:7 * b + 3]
    qpos[:, 7 * b:7 * b + 3] = (pos * [0.45, 0.45, 0.4]
                                + 0.03 * rng.normal(size=(n, 3)))
    q = rng.normal(size=(n, 4))
    qpos[:, 7 * b + 3:7 * b + 7] = q / np.linalg.norm(q, axis=-1,
                                                      keepdims=True)
  return qpos


def test_convex_pile_collision_matches_jax():
  """The `convex_pile` model (every collider group of ellipsoids,
  cylinders and meshes: 24 groups, 18 of them new) on 2 seeded states:
  the port's collision, dist, pos and frame of every slot, within 1e-9 of
  the JAX collision on the same qpos, but plane-cylinder's slots 1 and 2
  (MuJoCo's triangle, tests/test_torch_collision_pairs.py); no sphere
  centre lies inside a cylinder there. Most groups are in contact in these
  states."""
  mj = om.oracle_model('convex_pile')
  qpos = pile_states(mj, 2, 14)
  jm, jd, tm, td = oracle_pair(mj, qpos, np.zeros((2, mj.nv)))
  # the JAX collision env by env, unjitted (a jitted or vmapped trace of
  # the pile's 14 x 48 projections costs minutes)
  jc = [jcol.collision(jm, jkin.kinematics(
      jm, jax.tree.map(lambda x: x[e], jd))).contact for e in range(2)]
  jc = jax.tree.map(lambda *x: np.stack(x), *jc)
  td = tcol.collision(tm, tkin.kinematics(tm, td))
  s = tm.stat
  groups = s.pairs.groups
  assert len(groups) == 24 and s.pairs.ncon_max == 62
  keep = np.ones(s.pairs.ncon_max, bool)
  base = groups[(GeomType.PLANE, GeomType.CYLINDER)][3]
  for i in range(2):  # the two cylinders' slots 1 and 2
    keep[base + 4 * i + 1:base + 4 * i + 3] = False
  assert_close(td.contact.dist[:, keep], np.asarray(jc.dist)[:, keep], TOL,
               'dist')
  assert_close(td.contact.pos[:, keep], np.asarray(jc.pos)[:, keep], TOL,
               'pos')
  assert_close(td.contact.frame[:, keep], np.asarray(jc.frame)[:, keep], TOL,
               'frame')
  near = {k: float(td.contact.dist[:, g[3]:g[3] + len(g[0]) * g[4]].min())
          for k, g in groups.items()}
  assert sum(v < 0.01 for v in near.values()) >= 12, near
