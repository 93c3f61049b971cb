"""Convex-hull data of mesh geoms (host side, built with the model).

Counterpart of mjlab_tpu/physics/mesh.py. MuJoCo collides a mesh geom as
its convex hull. The engine precomputes each collidable mesh's hull as
static model constants (vertices for support lookups, outward face planes
and triangles for the exact point-to-hull projection), padded to one fixed
(MAX_HULL_VERT, MAX_HULL_FACE), so every mesh pair group is a single
vectorized narrowphase call with fixed shapes. The hulls are built with
qhull (scipy.spatial.ConvexHull) when the model is built; the step never
touches mesh topology.

`build_hulls` reads a compiled `mujoco.MjModel` or a `ModelArrays`
snapshot (physics/io.py) alike, so a host without the mujoco package
builds the same hulls from a snapshot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_GEOM_MESH = 7  # mjtGeom.mjGEOM_MESH

# Hull size cap: MuJoCo's compiler reduces a hull to `maxhullvert`
# vertices; a mesh beyond the cap is to be decimated when authored.
MAX_HULL_VERT = 64
# Euler: a convex polytope with V vertices has at most 2V - 4 triangles.
MAX_HULL_FACE = 2 * MAX_HULL_VERT - 4


class MeshHulls(NamedTuple):
  """Per-mesh padded hull arrays (numpy, static constants)."""

  vert: np.ndarray    # (nmesh, V, 3) hull vertices, mesh frame
  vmask: np.ndarray   # (nmesh, V) 1.0 for real vertices, 0.0 padding
  tri: np.ndarray     # (nmesh, F, 3, 3) face triangle corner coords
  fnorm: np.ndarray   # (nmesh, F, 3) outward unit face normals
  foff: np.ndarray    # (nmesh, F) plane offsets: inside <=> n.x <= off
  fmask: np.ndarray   # (nmesh, F) 1.0 for real faces
  center: np.ndarray  # (nmesh, 3) interior point (vertex centroid)
  rin: np.ndarray     # (nmesh,) inradius about center (min face margin)


def collidable_meshes(m) -> set:
  """The ids of the meshes that a collidable geom (contype or conaffinity
  nonzero) carries, of an MjModel or a ModelArrays snapshot."""
  return {int(m.geom_dataid[g]) for g in range(m.ngeom)
          if int(m.geom_type[g]) == _GEOM_MESH
          and (m.geom_contype[g] or m.geom_conaffinity[g])}


def build_hulls(m) -> 'MeshHulls | None':
  """Padded convex hulls of the collidable meshes of `m` (an MjModel or a
  ModelArrays snapshot), one row per mesh; None when no collidable geom
  carries a mesh (the reference then builds all-empty rows).

  A mesh that only visual geoms (contype == conaffinity == 0) carry is
  skipped: its rows stay zero-masked and the narrowphase, which runs only
  on pairs of collidable geoms, never reads them. So the MAX_HULL_VERT cap,
  which bounds the vectorized support search, does not apply to it."""
  collidable = collidable_meshes(m)
  if not collidable:
    return None
  from scipy.spatial import ConvexHull

  nmesh = int(m.nmesh)
  vert = np.zeros((nmesh, MAX_HULL_VERT, 3))
  vmask = np.zeros((nmesh, MAX_HULL_VERT))
  tri = np.zeros((nmesh, MAX_HULL_FACE, 3, 3))
  fnorm = np.zeros((nmesh, MAX_HULL_FACE, 3))
  foff = np.zeros((nmesh, MAX_HULL_FACE))
  fmask = np.zeros((nmesh, MAX_HULL_FACE))
  center = np.zeros((nmesh, 3))
  rin = np.zeros(nmesh)

  for i in range(nmesh):
    if i not in collidable:
      continue
    adr, num = int(m.mesh_vertadr[i]), int(m.mesh_vertnum[i])
    pts = np.asarray(m.mesh_vert[adr:adr + num], dtype=np.float64)
    hull = ConvexHull(pts)
    hv = pts[hull.vertices]
    if len(hv) > MAX_HULL_VERT:
      raise NotImplementedError(
          f'mesh {i} convex hull has {len(hv)} vertices '
          f'(> {MAX_HULL_VERT}); decimate the collision mesh or set '
          f'compiler maxhullvert')
    c = hv.mean(axis=0)
    # qhull's equations: n.x + d <= 0 inside, n the outward unit normal
    eq = hull.equations  # (F, 4)
    faces = pts[hull.simplices]  # (F, 3, 3)
    nf = len(faces)
    if nf > MAX_HULL_FACE:  # cannot happen for V <= cap, guard anyway
      raise NotImplementedError(f'mesh {i} hull has {nf} faces')

    nv = len(hv)
    vert[i, :nv] = hv
    vert[i, nv:] = hv[0]
    vmask[i, :nv] = 1.0
    tri[i, :nf] = faces
    tri[i, nf:] = faces[0]
    fnorm[i, :nf] = eq[:, :3]
    fnorm[i, nf:] = eq[0, :3]
    foff[i, :nf] = -eq[:, 3]
    foff[i, nf:] = -eq[0, 3]
    fmask[i, :nf] = 1.0
    center[i] = c
    rin[i] = float(np.min(foff[i, :nf] - fnorm[i, :nf] @ c))
    if rin[i] <= 0:
      raise ValueError(f'mesh {i}: degenerate (flat) convex hull')

  return MeshHulls(vert=vert, vmask=vmask, tri=tri, fnorm=fnorm,
                   foff=foff, fmask=fmask, center=center, rin=rin)
