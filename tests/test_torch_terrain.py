"""The port's terrains and heightfield collision against the JAX package.

Sub-terrain functions, the generator's raster and origins, and the
importer's levels, types and origins bit for bit (numpy on both sides);
the port's compiled heightfield (data, size, nrow, ncol, geom pos) against
MuJoCo's compile of the JAX importer's spec; the hfield colliders in
float64 against the JAX colliders at cell interiors, edges and vertices,
off the grid, in deep penetration and on stair treads where the two
triangles of a cell tie (the slot order included)."""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch.physics import collision as tcol
from mjlab_torch.physics import io as tio
from mjlab_torch.physics.types import GeomType
from mjlab_torch.terrains import config as tconfig
from mjlab_torch.terrains import generator as tgen
from mjlab_torch.terrains import importer as timp
from mjlab_torch.terrains import sub_terrains as tsub
from mjlab_tpu.physics import collision as jcol
from mjlab_tpu.physics import io as jio
from mjlab_tpu.terrains import config as jconfig
from mjlab_tpu.terrains import generator as jgen
from mjlab_tpu.terrains import importer as jimp
from mjlab_tpu.terrains import sub_terrains as jsub
from tests.torch_parity import data_leaves

# the small grid of these tests: 2 x 3 cells of 2 m, a 1 m border
SMALL = dict(size=(2.0, 2.0), border_width=1.0, num_rows=2, num_cols=3)

SUB_TERRAINS = {
    'BoxFlatTerrainCfg': {},
    'BoxPyramidStairsTerrainCfg': dict(
        step_height_range=(0.02, 0.12), step_width=0.2, platform_width=0.5,
        border_width=0.1),
    'BoxInvertedPyramidStairsTerrainCfg': dict(
        step_height_range=(0.02, 0.12), step_width=0.2, platform_width=0.5),
    'BoxRandomGridTerrainCfg': dict(grid_width=0.3,
                                    grid_height_range=(0.05, 0.1)),
    'HfRandomUniformTerrainCfg': dict(noise_range=(0.02, 0.1),
                                      border_width=0.25),
    'HfPyramidSlopedTerrainCfg': dict(slope_range=(0.1, 0.4),
                                      border_width=0.25),
    'HfInvertedPyramidSlopedTerrainCfg': dict(slope_range=(0.1, 0.4)),
    'HfWaveTerrainCfg': dict(amplitude_range=(0.05, 0.2), border_width=0.25),
}


def _port_cfg(jcfg):
  """The port's copy of a JAX TerrainGeneratorCfg (its sub-terrain cfgs
  rebuilt from the port's classes)."""
  subs = {k: getattr(tsub, type(v).__name__)(**dataclasses.asdict(v))
          for k, v in jcfg.sub_terrains.items()}
  fields = {f.name: getattr(jcfg, f.name)
            for f in dataclasses.fields(jcfg) if f.name != 'sub_terrains'}
  return tgen.TerrainGeneratorCfg(sub_terrains=subs, **fields)


@pytest.mark.parametrize('name', sorted(SUB_TERRAINS))
@pytest.mark.parametrize('difficulty', [0.0, 0.35, 1.0])
def test_sub_terrain_functions_match_jax(name, difficulty):
  want_cfg = getattr(jsub, name)(**SUB_TERRAINS[name])
  got_cfg = getattr(tsub, name)(**SUB_TERRAINS[name])
  assert dataclasses.asdict(want_cfg) == dataclasses.asdict(got_cfg)
  for c in (want_cfg, got_cfg):
    c.size = (3.0, 2.4)
  want = want_cfg.function(difficulty, np.random.default_rng(7), 30, 24, 0.1)
  got = got_cfg.function(difficulty, np.random.default_rng(7), 30, 24, 0.1)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g, w)


def _jax_small(base, **kw):
  cfg = copy.deepcopy(base)
  for k, v in {**SMALL, **kw}.items():
    setattr(cfg, k, v)
  return cfg


@pytest.mark.parametrize('which', ['ROUGH_TERRAINS_CFG',
                                   'ROUGH_TERRAINS_WITH_HF_CFG'])
@pytest.mark.parametrize('curriculum', [True, False])
def test_generator_raster_and_origins_match_jax(which, curriculum):
  jcfg = _jax_small(getattr(jconfig, which), curriculum=curriculum,
                    size=(4.0, 4.0), seed=3)
  tcfg = _port_cfg(jcfg)
  want, got = jgen.TerrainGenerator(jcfg), tgen.TerrainGenerator(tcfg)
  assert np.abs(want.raster).max() > 0
  np.testing.assert_array_equal(got.raster, want.raster)
  np.testing.assert_array_equal(got.origins, want.origins)
  assert (got.extent_x, got.extent_y) == (want.extent_x, want.extent_y)
  x = np.linspace(-got.extent_x - 1, got.extent_x + 1, 37)
  y = np.linspace(-got.extent_y - 1, got.extent_y + 1, 37)
  np.testing.assert_array_equal(got.sample_height(x, y),
                                want.sample_height(x, y))


def test_registered_rough_raster_matches_jax():
  """The registered 10 x 20 grid of 8 m cells with its 20 m border: the
  1200 x 2000 raster and its 200 origins, bit for bit."""
  want = jgen.TerrainGenerator(copy.deepcopy(jconfig.ROUGH_TERRAINS_CFG))
  got = tgen.TerrainGenerator(copy.deepcopy(tconfig.ROUGH_TERRAINS_CFG))
  assert got.raster.shape == (1200, 2000)
  np.testing.assert_array_equal(got.raster, want.raster)
  np.testing.assert_array_equal(got.origins, want.origins)


@pytest.mark.parametrize('num_envs', [2, 7])
def test_importer_levels_types_origins_match_jax(num_envs):
  jcfg = jimp.TerrainImporterCfg(
      terrain_type='generator',
      terrain_generator=_jax_small(jconfig.ROUGH_TERRAINS_CFG, num_rows=4,
                                   size=(4.0, 4.0)))
  want = jimp.TerrainImporter(jcfg, num_envs)
  got = timp.TerrainImporter(timp.TerrainImporterCfg(
      terrain_type='generator',
      terrain_generator=_port_cfg(jcfg.terrain_generator)), num_envs)
  for f in ('terrain_levels', 'terrain_types', 'env_origins',
            'origins_table'):
    np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                  err_msg=f)
  assert got.max_level == want.max_level == 4
  assert got.terrain_levels.max() < 2  # below max_init_terrain_level_ratio


def _compiled(jcfg, extra=None):
  """MuJoCo's compile of the spec the JAX importer builds from the
  generator cfg `jcfg`, a sphere, a capsule and a box on free joints added
  when `extra` (each colliding with the terrain only)."""
  spec = mujoco.MjSpec()
  jimp.TerrainImporter(jimp.TerrainImporterCfg(
      terrain_type='generator', terrain_generator=jcfg), 1, spec=spec)
  if extra:
    for name, gtype, size in (
        ('ball', mujoco.mjtGeom.mjGEOM_SPHERE, [0.07, 0, 0]),
        ('pill', mujoco.mjtGeom.mjGEOM_CAPSULE, [0.04, 0.15, 0]),
        ('brick', mujoco.mjtGeom.mjGEOM_BOX, [0.12, 0.08, 0.05])):
      body = spec.worldbody.add_body(name=name, pos=[0, 0, 1])
      body.add_joint(type=mujoco.mjtJoint.mjJNT_FREE)
      # each collides with the terrain only
      body.add_geom(name=name, type=gtype, size=size, mass=0.2, contype=1,
                    conaffinity=0)
  return spec.compile()


@pytest.mark.parametrize('which', ['ROUGH_TERRAINS_CFG',
                                   'ROUGH_TERRAINS_WITH_HF_CFG'])
def test_compiled_hfield_matches_mujoco(which):
  """The generator's numpy heightfield is what MuJoCo compiles from the
  JAX importer's spec: the normalized data, size, nrow, ncol, and the
  geom's pos, size and rgba, exactly; the engine's grid in meters equals
  the JAX engine's."""
  jcfg = _jax_small(getattr(jconfig, which), size=(4.0, 4.0), seed=5)
  mj = _compiled(jcfg)
  hf = tgen.TerrainGenerator(_port_cfg(jcfg)).hfield()
  assert mj.nhfield == 1 and mj.hfield_adr[0] == 0
  assert (hf.nrow, hf.ncol) == (mj.hfield_nrow[0], mj.hfield_ncol[0])
  np.testing.assert_array_equal(hf.data.reshape(-1), mj.hfield_data)
  assert hf.data.dtype == mj.hfield_data.dtype == np.float32
  np.testing.assert_array_equal(hf.size, mj.hfield_size[0])
  g = int(np.nonzero(mj.geom_type == int(GeomType.HFIELD))[0][0])
  np.testing.assert_array_equal(hf.geom_pos, mj.geom_pos[g])
  np.testing.assert_array_equal(tgen.hfield_geom_size(hf.size),
                                mj.geom_size[g])
  np.testing.assert_array_equal(hf.rgba, mj.geom_rgba[g])
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  jm = jio.put_model(mj, dtype=jnp.float64)
  np.testing.assert_array_equal(tm.hfield_data.numpy(),
                                np.asarray(jm.hfield_data))
  for f in ('nhfield', 'hfield_nrow', 'hfield_ncol', 'hfield_geomid'):
    assert getattr(tm.stat, f) == getattr(jm.stat, f), f
  np.testing.assert_array_equal(tm.stat.hfield_size, jm.stat.hfield_size)


# ---------------------------------------------------------------------------
# the colliders
# ---------------------------------------------------------------------------

# a grid of one 2 m cell of pyramid stairs at full difficulty: 0.1 m steps,
# treads 0.2 m wide, a 1 m border; hfield samples every 0.1 m
STAIRS = jgen.TerrainGeneratorCfg(
    size=(2.0, 2.0), border_width=1.0, num_rows=1, num_cols=1,
    difficulty_range=(1.0, 1.0), sub_terrains={
        'stairs': jsub.BoxPyramidStairsTerrainCfg(
            step_height_range=(0.1, 0.1), step_width=0.2,
            platform_width=0.5, border_width=0.1)})


@pytest.fixture(scope='module')
def stairs():
  mj = _compiled(copy.deepcopy(STAIRS), extra=True)
  jm = jio.put_model(mj, dtype=jnp.float64)
  tm = tphys.put_model(mj, device='cpu', dtype=torch.float64)
  return mj, jm, tm


def _pose(kind: str, case: str, rng):
  """(centre (3,), rotation (3, 3)) of the query geom for one case. The
  raster's vertices lie at -1.95 + 0.1 k on both axes; the surface is
  0 on the border and steps up 0.1 m a tread toward the centre."""
  v = -1.95 + 0.1 * np.array([12.0, 17.0])  # a vertex on a tread
  rot = np.eye(3)
  if case == 'interior':
    xy, z = v + [0.043, 0.061], 0.08
  elif case == 'edge':
    xy, z = v + [0.0, 0.052], 0.1
  elif case == 'vertex':
    xy, z = v, 0.11
  elif case == 'off_grid':
    xy, z = np.array([2.3, -0.4]), 0.05
  elif case == 'grid_border':
    xy, z = np.array([1.93, -1.0]), 0.03
  elif case == 'deep':
    xy, z = v + [0.031, 0.047], -0.09
  elif case == 'stair_tie':  # the flat tread under both of a cell's triangles
    xy, z = v + [0.05, 0.05], 0.14
  else:
    raise ValueError(case)
  if kind != 'sphere' and case not in ('stair_tie', 'vertex'):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    rot = np.zeros(9)
    mujoco.mju_quat2Mat(rot, q)
    rot = rot.reshape(3, 3)
  elif kind == 'capsule':  # lying along x, level with the tread
    rot = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
  return np.array([xy[0], xy[1], z]), rot


CASES = ('interior', 'edge', 'vertex', 'off_grid', 'grid_border', 'deep',
         'stair_tie')
KIND_OF = {'sphere': GeomType.SPHERE, 'capsule': GeomType.CAPSULE,
           'box': GeomType.BOX}


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('kind', sorted(KIND_OF))
def test_hfield_collider_matches_jax(stairs, kind, case):
  """Each hfield collider in float64 against the JAX one, on three envs
  (the case's pose and two jittered copies, the terrain geom lifted in the
  third), to 1e-9 with the candidates' order: the slots come out in the
  same order, so the efc rows and the warmstart would too."""
  mj, jm, tm = stairs
  key = (int(GeomType.HFIELD), int(KIND_OF[kind]))
  g1s, g2s, _, _, npts = tm.stat.pairs.groups[key]
  assert jm.stat.pairs.groups[key][4] == npts
  rng = np.random.default_rng(CASES.index(case))
  centre, rot = _pose(kind, case, rng)
  geom = int(g2s[0])
  jd0 = jio.make_data(jm, dtype=jnp.float64)
  xpos = np.tile(np.asarray(jd0.geom_xpos), (3, 1, 1))
  xmat = np.tile(np.asarray(jd0.geom_xmat), (3, 1, 1, 1))
  for e in range(3):
    xpos[e, geom] = centre + (0 if e == 0 else 1e-3 * rng.normal(size=3))
    xmat[e, geom] = rot
  xpos[2, int(g1s[0]), 2] += 0.02  # the terrain geom moved up
  jd = jax.tree.map(lambda x: jnp.broadcast_to(x, (3,) + x.shape), jd0)
  jd = jd.replace(geom_xpos=jnp.asarray(xpos), geom_xmat=jnp.asarray(xmat))
  fn = {GeomType.SPHERE: '_hfield_sphere', GeomType.CAPSULE:
        '_hfield_capsule', GeomType.BOX: '_hfield_box'}[KIND_OF[kind]]
  want = jax.vmap(lambda d: getattr(jcol, fn)(jm, d, g1s, g2s, npts))(jd)
  td = tphys.data_from_numpy(data_leaves(jd), tm)
  got = getattr(tcol, fn)(tm, td, g1s, g2s, npts)
  for g, w, what in zip(got, want, ('dist', 'pos', 'normal')):
    w = np.asarray(w)
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9,
                               err_msg=what)
  dist = got[0].numpy()
  if case == 'off_grid':
    assert (dist == 1e10).all()
  elif case == 'deep':
    assert dist[0].min() < -0.05
  elif case == 'stair_tie':
    assert (dist[0] < 0.1).sum() >= 2


def test_collision_fills_the_hfield_slots_as_jax(stairs):
  """collision() with every body dropped onto the stairs: the whole contact
  set (the hfield slots of all three pairs and their frames, friction and
  solver parameters) against the JAX package."""
  mj, jm, tm = stairs
  rng = np.random.default_rng(11)
  n = 4
  qpos = np.tile(mj.qpos0, (n, 1))
  for b in range(3):
    qpos[:, 7 * b:7 * b + 3] = rng.uniform([-1.2, -1.2, 0.05],
                                           [1.2, 1.2, 0.25], size=(n, 3))
    q = rng.normal(size=(n, 4))
    qpos[:, 7 * b + 3:7 * b + 7] = q / np.linalg.norm(q, axis=-1,
                                                      keepdims=True)
  from mjlab_tpu.physics import kinematics as jkin
  jd = jax.vmap(lambda q: jkin.kinematics(
      jm, jio.make_data(jm, dtype=jnp.float64).replace(qpos=q)))(
          jnp.asarray(qpos))
  want = jax.vmap(lambda d: jcol.collision(jm, d))(jd)
  td = tphys.data_from_numpy(data_leaves(jd), tm)
  got = tcol.collision(tm, td)
  for f in tio.CONTACT_FIELDS:
    np.testing.assert_allclose(getattr(got.contact, f).numpy(),
                               np.asarray(getattr(want.contact, f)), rtol=0,
                               atol=1e-9, err_msg=f)
  np.testing.assert_array_equal(got.ncon_active.numpy(),
                                np.asarray(want.ncon_active))
  assert int(got.ncon_active.sum()) > 0


def test_float32_penetration_keeps_its_sign():
  """A fault of the reference's own, not carried over: it decides that a
  query point projects inside a triangle by d - |sd| < 1e-9, which float32
  rounding of the closest point and of d breaks at the registered grid's
  coordinates (up to ~100 m), so a sphere below the surface reads as above
  it, its normal pointing down. The port also takes the closest point's
  region tests: in float32 every one of 4,000 spheres sunk 1-30 mm into a
  flat grid of the registered size keeps its depth and an upward normal,
  as in float64, where the JAX collider loses some."""
  nrow, ncol = 2000, 1200
  size = np.array([(ncol - 1) * 0.05, (nrow - 1) * 0.05, 1.0, 1.0])
  rng = np.random.default_rng(0)
  n = 4000
  pts = np.c_[rng.uniform(-55, 55, n), rng.uniform(-95, 95, n),
              -rng.uniform(0.001, 0.03, n)]
  want = pts[:, 2] - 0.02

  def deepest(dist, normal):
    dist, normal = np.asarray(dist), np.asarray(normal)
    best = dist.argmin(-1)
    return dist[np.arange(n), best], normal[np.arange(n), best, 2]

  for dt in (torch.float32, torch.float64):
    d, nz = deepest(*tcol._hf_point_candidates(
        torch.zeros(nrow, ncol, dtype=dt), size, nrow, ncol,
        torch.as_tensor(pts, dtype=dt), torch.full((n,), 0.02, dtype=dt))[::2])
    np.testing.assert_allclose(d, want, rtol=0, atol=1e-5, err_msg=str(dt))
    assert (nz > 0.999).all(), dt
  d, nz = deepest(*jcol._hf_point_candidates(
      jnp.zeros((nrow, ncol), jnp.float32), size, nrow, ncol,
      jnp.asarray(pts, jnp.float32), jnp.full((n,), 0.02, jnp.float32))[::2])
  lost = np.abs(d - want) > 1e-4
  assert lost.sum() > 0 and (nz[lost] < 0).all()
