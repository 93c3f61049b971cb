"""Triangle meshes of MuJoCo's primitive geoms, in numpy.

Counterpart of mjlab_tpu/viewer/primitives.py, array for array: spheres,
capsules, cylinders, boxes, ellipsoids, planes and arrows are triangulated
here (no trimesh), and a mesh geom's own mesh is read from a compiled
mujoco.MjModel. The viser viewer draws its geom handles with these.
`geom_mesh` takes the geom type as an int of the port's `GeomType`
(physics/types.py), so it needs no mujoco package."""

from __future__ import annotations

import numpy as np

from mjlab_torch.physics.types import GeomType


def uv_sphere(radius: float, rings: int = 12, sectors: int = 24,
              z_offset: float = 0.0, half: str | None = None):
  """UV sphere (optionally top/bottom hemisphere) -> (verts, faces)."""
  if half == 'top':
    phis = np.linspace(0, np.pi / 2, rings)
  elif half == 'bottom':
    phis = np.linspace(np.pi / 2, np.pi, rings)
  else:
    phis = np.linspace(0, np.pi, rings)
  thetas = np.linspace(0, 2 * np.pi, sectors, endpoint=False)
  verts = []
  for phi in phis:
    for th in thetas:
      verts.append([radius * np.sin(phi) * np.cos(th),
                    radius * np.sin(phi) * np.sin(th),
                    radius * np.cos(phi) + z_offset])
  verts = np.asarray(verts)
  faces = []
  for r in range(len(phis) - 1):
    for s in range(sectors):
      a = r * sectors + s
      b = r * sectors + (s + 1) % sectors
      c = (r + 1) * sectors + s
      d = (r + 1) * sectors + (s + 1) % sectors
      faces.append([a, d, b])
      faces.append([a, c, d])
  return verts, np.asarray(faces, np.int32)


def cylinder_shell(radius: float, half_len: float, sectors: int = 24,
                   caps: bool = True):
  thetas = np.linspace(0, 2 * np.pi, sectors, endpoint=False)
  top = np.stack([radius * np.cos(thetas), radius * np.sin(thetas),
                  np.full(sectors, half_len)], -1)
  bot = np.stack([radius * np.cos(thetas), radius * np.sin(thetas),
                  np.full(sectors, -half_len)], -1)
  verts = [top, bot]
  faces = []
  for s in range(sectors):
    a, b = s, (s + 1) % sectors
    c, d = sectors + s, sectors + (s + 1) % sectors
    faces.append([a, c, b])
    faces.append([b, c, d])
  n = 2 * sectors
  if caps:
    verts.append(np.asarray([[0, 0, half_len], [0, 0, -half_len]]))
    for s in range(sectors):
      a, b = s, (s + 1) % sectors
      faces.append([n, a, b])
      c, d = sectors + s, sectors + (s + 1) % sectors
      faces.append([n + 1, d, c])
  return np.concatenate(verts), np.asarray(faces, np.int32)


def weld_vertices(verts, faces, tol: float = 1e-7):
  """Merge coincident vertices so composite meshes are watertight."""
  key = np.round(verts / tol).astype(np.int64)
  _, first, inverse = np.unique(key, axis=0, return_index=True,
                                return_inverse=True)
  faces = inverse[faces].astype(np.int32)
  ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2]))
  return verts[first], faces[ok]


def capsule_mesh(radius: float, half_len: float, rings: int = 8,
                 sectors: int = 24):
  """Capsule along z: cylinder shell + hemisphere caps (welded)."""
  cv, cf = cylinder_shell(radius, half_len, sectors, caps=False)
  tv, tf = uv_sphere(radius, rings, sectors, z_offset=half_len, half='top')
  bv, bf = uv_sphere(radius, rings, sectors, z_offset=-half_len,
                     half='bottom')
  verts = np.concatenate([cv, tv, bv])
  faces = np.concatenate([cf, tf + len(cv), bf + len(cv) + len(tv)])
  return weld_vertices(verts, faces)


def box_mesh(half_sizes) -> tuple:
  hx, hy, hz = half_sizes
  v = np.asarray([[x, y, z] for x in (-hx, hx) for y in (-hy, hy)
                  for z in (-hz, hz)])
  f = np.asarray([
      [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
  return v, f


def arrow_mesh(length: float = 1.0, radius: float = 0.02,
               head_frac: float = 0.25, sectors: int = 12):
  """Unit arrow along +z (shaft cylinder + cone head); scale at use."""
  shaft_len = length * (1 - head_frac)
  sv, sf = cylinder_shell(radius, shaft_len / 2, sectors)
  sv = sv + np.asarray([0, 0, shaft_len / 2])
  thetas = np.linspace(0, 2 * np.pi, sectors, endpoint=False)
  ring = np.stack([2.2 * radius * np.cos(thetas),
                   2.2 * radius * np.sin(thetas),
                   np.full(sectors, shaft_len)], -1)
  tip = np.asarray([[0, 0, length], [0, 0, shaft_len]])
  hv = np.concatenate([ring, tip])
  hf = []
  for s in range(sectors):
    a, b = s, (s + 1) % sectors
    hf.append([sectors, a, b])      # side to tip
    hf.append([sectors + 1, b, a])  # base disk
  verts = np.concatenate([sv, hv])
  faces = np.concatenate([sf, np.asarray(hf, np.int32) + len(sv)])
  return verts, faces


def geom_mesh(gtype: int, size, plane_extent: float = 5.0):
  """Mesh for a geom type (an int of GeomType) and size; None for a mesh
  or heightfield geom (`mujoco_mesh` reads a mesh geom's own mesh)."""
  t = int(gtype)
  if t == GeomType.SPHERE:
    return uv_sphere(float(size[0]))
  if t == GeomType.CAPSULE:
    return capsule_mesh(float(size[0]), float(size[1]))
  if t == GeomType.CYLINDER:
    return cylinder_shell(float(size[0]), float(size[1]))
  if t == GeomType.BOX:
    return box_mesh(np.asarray(size[:3], float))
  if t == GeomType.ELLIPSOID:
    v, f = uv_sphere(1.0)
    return v * np.asarray(size[:3], float), f
  if t == GeomType.PLANE:
    e = plane_extent if size[0] == 0 else float(size[0])
    v = np.asarray([[-e, -e, 0], [e, -e, 0], [e, e, 0], [-e, e, 0]], float)
    f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    return v, f
  return None


def mujoco_mesh(mj, g: int):
  """(verts, faces) of mesh geom `g`'s own mesh in the geom's frame, read
  from the compiled mujoco.MjModel `mj`; None for any other geom."""
  if mj.geom_type[g] != GeomType.MESH:
    return None
  mid = int(mj.geom_dataid[g])
  if mid < 0:
    return None
  va, vn = int(mj.mesh_vertadr[mid]), int(mj.mesh_vertnum[mid])
  fa, fn = int(mj.mesh_faceadr[mid]), int(mj.mesh_facenum[mid])
  verts = np.asarray(mj.mesh_vert[va:va + vn], float)
  faces = np.asarray(mj.mesh_face[fa:fa + fn], np.int32)
  return verts, faces
