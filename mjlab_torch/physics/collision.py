"""Narrowphase collision over the static pair table, on a batch of envs.

Counterpart of mjlab_tpu/physics/collision.py. Broadphase is resolved when
the model is built (io._build_pairs); each pair group is one vectorized
narrowphase call producing a fixed number of candidate contacts per pair.
Inactive candidates keep dist >= includemargin and are masked out of the
constraint rows.

Every pair of the JAX engine's table (io._COLLIDER_POINTS) has its
collider here: the primitive pairs of the plane, sphere, capsule and box;
plane-ellipsoid, plane-cylinder, sphere-ellipsoid and sphere-cylinder;
the convex-solid pairs of ellipsoids, cylinders and boxes (erosion and
alternating projection, `_convex_core`); the heightfield pairs; and the
mesh pairs, against each mesh's precomputed convex hull (physics/mesh.py).

Where the reference's collider is wrong, the port does not carry it over
(ROADMAP.md §3): plane-cylinder takes MuJoCo's contact set (the reference
puts its three near-cap points within 45 degrees of the deepest one, so a
cylinder on its cap has no support on one side), sphere-cylinder pushes a
sphere whose centre lies inside the cylinder out through the nearest
surface (the reference gives a depth of the radius and a fixed normal),
and the convex cores decide deep overlap by the projections' own inside
tests besides the reference's 1e-9 distance (float32 rounding defeats the
distance alone).

Contact conventions match MuJoCo: normal points from geom1 into geom2,
dist < 0 means penetration, pos is the midpoint between the surfaces.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.physics import math as pmath
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.tables import table
from mjlab_torch.physics.types import Data, GeomType, Model

_MJMINVAL = 1e-15


def _plane_sphere(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  r = s2[..., 0]
  dist = ((p2 - p1) * n).sum(-1) - r
  pos = p2 - n * (r + 0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_capsule(p1, m1, s1, p2, m2, s2):
  n = m1[..., :, 2]
  r, hl = s2[..., 0], s2[..., 1]
  axis = m2[..., :, 2]
  half = axis * hl[..., None]
  ends = torch.stack([p2 + half, p2 - half], -2)
  cdist = ((ends - p1[..., None, :]) * n[..., None, :]).sum(-1)
  dist = cdist - r[..., None]
  pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
  nrm = n[..., None, :].expand(pos.shape)
  # MuJoCo aligns the first tangent with the capsule axis projected onto
  # the plane; a near-vertical capsule falls back to the generic frame
  proj = axis - n * (axis * n).sum(-1, keepdim=True)
  pn = torch.linalg.vector_norm(proj, dim=-1, keepdim=True)
  generic = pmath.make_tangent_frame(n)[..., 1, :]
  t1 = torch.where(pn > 1e-9, proj / pn.clamp_min(1e-12), generic)
  return dist, pos, nrm, t1[..., None, :].expand(pos.shape)


_BOX_SIGNS = np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                         for z in (-1, 1)], np.float64)  # (8, 3)


def _plane_box(p1, m1, s1, p2, m2, s2):
  """The 4 deepest of the box's 8 corners, each at corner - n dist / 2,
  with the plane's normal. The sort is stable: a box lying flat has four
  corners at one depth, and their order fixes the contact slots' order,
  as jnp.argsort's does in the reference."""
  n = m1[..., :, 2]
  corners_local = table(_BOX_SIGNS, p2.dtype, p2.device) * s2[..., None, :3]
  corners = p2[..., None, :] + torch.einsum('...ij,...kj->...ki', m2,
                                            corners_local)
  cdist = ((corners - p1[..., None, :]) * n[..., None, :]).sum(-1)
  idx = torch.argsort(cdist, dim=-1, stable=True)[..., :4]
  dist = torch.take_along_dim(cdist, idx, dim=-1)
  pts = torch.take_along_dim(corners, idx[..., None], dim=-2)
  pos = pts - n[..., None, :] * (0.5 * dist)[..., None]
  return dist, pos, n[..., None, :].expand(pos.shape)


def _plane_ellipsoid(p1, m1, s1, p2, m2, s2):
  """The ellipsoid's support point in -n: x = -diag(s)^2 R^T n /
  |diag(s) R^T n|."""
  n = m1[..., :, 2]
  nl = torch.einsum('...ji,...j->...i', m2, n)  # n in the ellipsoid's frame
  sn = s2[..., :3] * nl
  denom = torch.linalg.vector_norm(sn, dim=-1).clamp_min(_MJMINVAL)
  xl = -(s2[..., :3] ** 2) * nl / denom[..., None]
  x = p2 + torch.einsum('...ij,...j->...i', m2, xl)
  dist = ((x - p1) * n).sum(-1)
  pos = x - n * (0.5 * dist)[..., None]
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _plane_cylinder(p1, m1, s1, p2, m2, s2):
  """MuJoCo's plane-cylinder contacts (mjc_PlaneCylinder): the rim point
  of the near cap toward the plane, the two other corners of the
  equilateral triangle inscribed in that cap, and the rim point of the far
  cap on the near side; a cap parallel to the plane takes the cylinder's x
  axis as its rim direction. Slots 0 and 3 are the reference's; its slots
  1 and 2 (the near cap's points at +-45 degrees from slot 0, or all three
  at the cap's centre when the cap is parallel) are not carried over."""
  n = m1[..., :, 2]
  r, hl = s2[..., 0], s2[..., 1]
  axis = m2[..., :, 2]
  pn = (n * axis).sum(-1)
  rim = -(n - axis * pn[..., None])  # toward the plane, in the cap's plane
  rimn = torch.linalg.vector_norm(rim, dim=-1)
  rim = torch.where((rimn > _MJMINVAL)[..., None],
                    rim / rimn.clamp_min(_MJMINVAL)[..., None],
                    m2[..., :, 0])
  sgn = 1.0 - 2.0 * (pn > 0).to(pn.dtype)  # the near cap
  half = axis * (sgn * hl)[..., None]
  cap = p2 + half
  vec = rim * r[..., None]
  side = pmath.cross(vec, half)
  side = side * (r * 0.5 * 3.0 ** 0.5 / torch.linalg.vector_norm(
      side, dim=-1).clamp_min(_MJMINVAL))[..., None]
  mid = cap - 0.5 * vec
  pts = torch.stack([cap + vec, mid + side, mid - side, p2 - half + vec], -2)
  cdist = ((pts - p1[..., None, :]) * n[..., None, :]).sum(-1)
  pos = pts - n[..., None, :] * (0.5 * cdist)[..., None]
  return cdist, pos, n[..., None, :].expand(pos.shape)


def _sphere_sphere_raw(p1, r1, p2, r2):
  delta = p2 - p1
  cd = torch.linalg.vector_norm(delta, dim=-1)
  n = delta / cd.clamp_min(_MJMINVAL)[..., None]
  ez = table(pmath._EZ, n.dtype, n.device).expand(n.shape)
  n = torch.where((cd > _MJMINVAL)[..., None], n, ez)
  dist = cd - r1 - r2
  pos = p1 + n * (r1 + 0.5 * dist)[..., None]
  return dist, pos, n


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
  dist, pos, n = _sphere_sphere_raw(p1, s1[..., 0], p2, s2[..., 0])
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_ends(p, m, hl):
  half = m[..., :, 2] * hl[..., None]
  return p - half, p + half


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
  a, b = _capsule_ends(p2, m2, s2[..., 1])
  closest = pmath.closest_segment_point(a, b, p1)
  dist, pos, n = _sphere_sphere_raw(p1, s1[..., 0], closest, s2[..., 0])
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
  a0, a1 = _capsule_ends(p1, m1, s1[..., 1])
  b0, b1 = _capsule_ends(p2, m2, s2[..., 1])
  pa, pb = pmath.closest_segment_segment(a0, a1, b0, b1)
  dist, pos, n = _sphere_sphere_raw(pa, s1[..., 0], pb, s2[..., 0])
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _sphere_box_raw(center, r, pb, mb, sb):
  """Sphere (center, r) against a box (pb, rotation mb, half-sizes sb):
  outside, the closest surface point; inside, out through the nearest
  face. The normal points from the sphere into the box."""
  local = torch.einsum('...ji,...j->...i', mb, center - pb)
  half = sb[..., :3].expand(local.shape)
  clamped = torch.minimum(torch.maximum(local, -half), half)
  inside = (local.abs() < half).all(-1)
  delta_out = local - clamped
  d_out = torch.linalg.vector_norm(delta_out, dim=-1)
  n_out = delta_out / d_out.clamp_min(_MJMINVAL)[..., None]
  face_d = half - local.abs()
  ax = torch.argmin(face_d, dim=-1, keepdim=True)
  sgn = torch.sign(torch.gather(local, -1, ax)[..., 0])
  sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
  hot = torch.nn.functional.one_hot(ax[..., 0], 3).to(local.dtype)
  n_in = hot * sgn[..., None]
  d_in = -torch.gather(face_d, -1, ax)[..., 0]
  surf_in = torch.where(hot > 0.5, half * sgn[..., None], local)
  dist_l = torch.where(inside, d_in - r, d_out - r)
  n_l = torch.where(inside[..., None], n_in, n_out)
  surf_l = torch.where(inside[..., None], surf_in, clamped)
  n_w = -torch.einsum('...ij,...j->...i', mb, n_l)
  surf_w = pb + torch.einsum('...ij,...j->...i', mb, surf_l)
  pos = surf_w + n_w * (0.5 * dist_l)[..., None]
  return dist_l, pos, n_w


def _sphere_box(p1, m1, s1, p2, m2, s2):
  dist, pos, n = _sphere_box_raw(p1, s1[..., 0], p2, m2, s2)
  return dist[..., None], pos[..., None, :], n[..., None, :]


def _sphere_cylinder(p1, m1, s1, p2, m2, s2):
  """The sphere's centre against the cylinder's closest surface point
  (the reference's clamp to the solid); a centre inside the cylinder
  leaves through the nearest surface, side or cap (MuJoCo's
  sphere-cylinder), where the reference's clamp returns the centre itself:
  a depth of the radius and a fixed world -z normal."""
  r1 = s1[..., 0]
  r2, hl = s2[..., 0], s2[..., 1]
  axis = m2[..., :, 2]
  rel = p1 - p2
  z = (rel * axis).sum(-1)
  radial = rel - axis * z[..., None]
  rn = torch.linalg.vector_norm(radial, dim=-1)
  zc = torch.minimum(torch.maximum(z, -hl), hl)
  rc = torch.minimum(rn, r2)
  rdir = radial / rn.clamp_min(_MJMINVAL)[..., None]
  closest = p2 + axis * zc[..., None] + rdir * rc[..., None]
  dist, pos, n = _sphere_sphere_raw(closest, torch.zeros_like(r1), p1, r1)
  # the centre inside: out through the side or the nearer cap
  side_d, cap_d = r2 - rn, hl - z.abs()
  inside = (side_d > 0) & (cap_d > 0)
  rdir = torch.where((rn > _MJMINVAL)[..., None], rdir, m2[..., :, 0])
  zs = 1.0 - 2.0 * (z < 0).to(z.dtype)
  by_side = side_d < cap_d
  out = torch.where(by_side[..., None], rdir, axis * zs[..., None])
  surf = torch.where(by_side[..., None],
                     p2 + axis * z[..., None] + rdir * r2[..., None],
                     p2 + axis * (zs * hl)[..., None] + radial)
  d_in = -torch.where(by_side, side_d, cap_d) - r1
  dist = torch.where(inside, d_in, dist)
  n = torch.where(inside[..., None], out, n)
  pos = torch.where(inside[..., None], surf + out * (0.5 * d_in)[..., None],
                    pos)
  # normal from the cylinder's surface toward the sphere -> flipped
  # (geom1 is the sphere)
  return dist[..., None], pos[..., None, :], (-n)[..., None, :]


def _capsule_box(p1, m1, s1, p2, m2, s2):
  """The JAX engine's capsule-box: each end sphere of the capsule against
  the box (2 candidates)."""
  a, b = _capsule_ends(p1, m1, s1[..., 1])
  r = s1[..., 0]
  d1, pos1, n1 = _sphere_box_raw(a, r, p2, m2, s2)
  d2, pos2, n2 = _sphere_box_raw(b, r, p2, m2, s2)
  return (torch.stack([d1, d2], -1), torch.stack([pos1, pos2], -2),
          torch.stack([n1, n2], -2))


def _box_box(p1, m1, s1, p2, m2, s2):
  """The JAX engine's approximate box-box: each box's corners against the
  other box's faces, the 4 deepest of either (8 candidates; the second
  box's normals flipped to point from the first into the second)."""

  def corners_vs_box(pa, ma, sa, pb, mb, sb, flip: bool):
    local = table(_BOX_SIGNS, pa.dtype, pa.device) * sa[..., None, :3]
    corners = pa[..., None, :] + torch.einsum('...ij,...kj->...ki', ma,
                                              local)
    shape = corners.shape
    dist, pos, n = _sphere_box_raw(
        corners, corners.new_zeros(shape[:-1]),
        pb[..., None, :].expand(shape),
        mb[..., None, :, :].expand(shape + (3,)), sb[..., None, :])
    idx = torch.argsort(dist, dim=-1, stable=True)[..., :4]
    n = torch.take_along_dim(n, idx[..., None], dim=-2)
    return (torch.take_along_dim(dist, idx, dim=-1),
            torch.take_along_dim(pos, idx[..., None], dim=-2),
            -n if flip else n)

  d1, pos1, n1 = corners_vs_box(p1, m1, s1, p2, m2, s2, False)
  d2, pos2, n2 = corners_vs_box(p2, m2, s2, p1, m1, s1, True)
  return (torch.cat([d1, d2], -1), torch.cat([pos1, pos2], -2),
          torch.cat([n1, n2], -2))


_COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): _plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
    (GeomType.PLANE, GeomType.BOX): _plane_box,
    (GeomType.SPHERE, GeomType.SPHERE): _sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): _sphere_capsule,
    (GeomType.SPHERE, GeomType.BOX): _sphere_box,
    (GeomType.CAPSULE, GeomType.CAPSULE): _capsule_capsule,
    (GeomType.CAPSULE, GeomType.BOX): _capsule_box,
    (GeomType.BOX, GeomType.BOX): _box_box,
    (GeomType.PLANE, GeomType.ELLIPSOID): _plane_ellipsoid,
    (GeomType.PLANE, GeomType.CYLINDER): _plane_cylinder,
    (GeomType.SPHERE, GeomType.CYLINDER): _sphere_cylinder,
}


# ---------------------------------------------------------------------------
# Heightfield narrowphase. The terrain grid lives in Model.hfield_data
# (meters, (nrow, ncol), rows along y); each query point tests the two
# triangles of every cell of a fixed 3x3 neighbourhood of its footprint:
# fixed-shape gathers, natively batched over the envs.
# ---------------------------------------------------------------------------


def _closest_on_triangle(p, a, b, c):
  """Closest point on triangle abc to point p (Ericson 5.1.5), every input
  (..., 3) and broadcast against the others; and whether it lies in the
  triangle's interior (p projects inside the triangle), from the same
  region tests."""
  dot = lambda x, y: (x * y).sum(-1)
  eps = 1e-12
  ab = b - a
  ac = c - a
  ap = p - a
  d1 = dot(ab, ap)
  d2 = dot(ac, ap)
  bp = p - b
  d3 = dot(ab, bp)
  d4 = dot(ac, bp)
  cp = p - c
  d5 = dot(ab, cp)
  d6 = dot(ac, cp)
  va = d3 * d6 - d5 * d4
  vb = d5 * d2 - d1 * d6
  vc = d1 * d4 - d3 * d2
  guard = lambda x: torch.where(x.abs() < eps, eps, x)

  # interior
  denom = guard(va + vb + vc)
  res = a + ab * (vb / denom)[..., None] + ac * (vc / denom)[..., None]
  # edge BC
  t_bc = (d4 - d3) / guard((d4 - d3) + (d5 - d6))
  on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
  res = torch.where(on_bc[..., None], b + (c - b) * t_bc[..., None], res)
  # edge AC
  t_ac = d2 / guard(d2 - d6)
  on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
  res = torch.where(on_ac[..., None], a + ac * t_ac[..., None], res)
  # vertex C
  on_c = (d6 >= 0) & (d5 <= d6)
  res = torch.where(on_c[..., None], c, res)
  # edge AB
  t_ab = d1 / guard(d1 - d3)
  on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
  res = torch.where(on_ab[..., None], a + ab * t_ab[..., None], res)
  # vertex B
  on_b = (d3 >= 0) & (d4 <= d3)
  res = torch.where(on_b[..., None], b, res)
  # vertex A
  on_a = (d1 <= 0) & (d2 <= 0)
  res = torch.where(on_a[..., None], a, res)
  interior = ~(on_bc | on_ac | on_c | on_ab | on_b | on_a)
  return res, interior


_CELL_DI = (-1, -1, -1, 0, 0, 0, 1, 1, 1)  # the 3x3 cells, row offsets
_CELL_DJ = (-1, 0, 1, -1, 0, 1, -1, 0, 1)  # column offsets


def _hf_point_candidates(hf, size, nrow, ncol, pts, radius):
  """Candidate contacts of query spheres against the heightfield.

  hf: (nrow, ncol) meters. pts: (..., 3) sphere centres in the hfield
  geom's frame, radius: broadcastable to pts[..., 0]. Returns (dist, pos,
  normal) with a trailing candidate axis of 18 (3x3 cells x 2 triangles);
  an invalid candidate has dist = 1e10. All in the geom's frame.

  The hfield's sizes enter as Python floats, so a float32 collider stays
  float32."""
  rx, ry = float(size[0]), float(size[1])
  cx = 2.0 * rx / (ncol - 1)
  cy = 2.0 * ry / (nrow - 1)
  dtype, dev = pts.dtype, pts.device
  u = (pts[..., 0] + rx) / cx  # continuous column coordinate
  v = (pts[..., 1] + ry) / cy  # continuous row coordinate
  j0 = torch.floor(u).long()
  i0 = torch.floor(v).long()
  i = i0[..., None] + table(np.asarray(_CELL_DI), torch.long, dev)
  j = j0[..., None] + table(np.asarray(_CELL_DJ), torch.long, dev)
  valid = (i >= 0) & (i < nrow - 1) & (j >= 0) & (j < ncol - 1)
  ic = i.clamp(0, nrow - 2)
  jc = j.clamp(0, ncol - 2)

  x0 = -rx + jc.to(dtype) * cx
  x1 = x0 + cx
  y0 = -ry + ic.to(dtype) * cy
  y1 = y0 + cy
  flat = hf.reshape(-1)
  at = ic * ncol + jc
  z00 = flat[at]
  z10 = flat[at + 1]
  z01 = flat[at + ncol]
  z11 = flat[at + ncol + 1]
  p00 = torch.stack([x0, y0, z00], -1)  # (..., 9, 3)
  p10 = torch.stack([x1, y0, z10], -1)
  p01 = torch.stack([x0, y1, z01], -1)
  p11 = torch.stack([x1, y1, z11], -1)

  # two triangles a cell: (p00, p10, p11) and (p00, p11, p01)
  a = torch.cat([p00, p00], -2)  # (..., 18, 3)
  b = torch.cat([p10, p11], -2)
  c = torch.cat([p11, p01], -2)
  valid2 = torch.cat([valid, valid], -1)

  pe = pts[..., None, :]
  cp, interior = _closest_on_triangle(pe, a, b, c)
  n_tri = pmath.cross(b - a, c - a)
  n_tri = n_tri / torch.linalg.vector_norm(
      n_tri, dim=-1, keepdim=True).clamp_min(1e-12)
  delta = pe - cp
  d = torch.linalg.vector_norm(delta, dim=-1)
  sd = (delta * n_tri).sum(-1)
  # a projection inside the triangle takes the signed plane distance (deep
  # penetration); an edge or a corner the unsigned euclidean one. The
  # reference decides "inside" by d - |sd| < 1e-9 alone, which holds on the
  # triangle's boundary too; float32 rounding of d and of the closest point
  # (coordinates up to ~100 m) breaks it in the interior, where a sphere
  # below the surface then reads as above it, its normal pointing down.
  # The closest point's region tests catch the interior; in float64 the
  # union decides as the reference does.
  inside = interior | ((d - sd.abs()) < 1e-9)
  r = radius[..., None]
  dist = torch.where(inside, sd, d) - r
  n_edge = delta / d.clamp_min(1e-12)[..., None]
  normal = torch.where(inside[..., None], n_tri, n_edge)
  pos = 0.5 * (cp + pe - normal * r[..., None])  # midpoint of the surfaces
  dist = torch.where(valid2, dist, 1e10)
  return dist, pos, normal


def _dedup_candidates(dist, pos):
  """Invalidate a candidate whose contact pos duplicates a deeper one
  (adjacent triangles sharing an edge give identical closest points):
  candidate i is a duplicate if some j with (dist_j, j) < (dist_i, i),
  depth first and index as the tiebreak, lies within 1e-5 of it."""
  k = dist.shape[-1]
  d2 = sum((pos[..., :, None, x] - pos[..., None, :, x]).square()
           for x in range(3))
  same = d2 < 1e-10
  di = dist[..., :, None]
  dj = dist[..., None, :]
  idx = torch.arange(k, device=dist.device)
  better = (dj < di) | ((dj == di) & (idx[None, :] < idx[:, None]))
  dup = (same & better).any(-1)
  return torch.where(dup, 1e10, dist)


def _hf_select(d: Data, gh: int, dist, pos, normal, npts):
  """The npts deepest candidates in the hfield geom's world frame. The
  sort is stable, so equal depths (the two triangles of a flat cell, every
  invalid candidate) keep the lower index first, as the reference's
  `lax.top_k` does; the slots' order fixes the efc rows and the
  warmstart."""
  dist = _dedup_candidates(dist, pos)
  top = torch.argsort(dist, dim=-1, stable=True)[..., :npts]
  dist = torch.take_along_dim(dist, top, dim=-1)
  pos = torch.take_along_dim(pos, top[..., None], dim=-2)
  normal = torch.take_along_dim(normal, top[..., None], dim=-2)
  ph, rh = d.geom_xpos[:, gh], d.geom_xmat[:, gh]
  pos = ph[:, None, None, :] + torch.einsum('bij,bnkj->bnki', rh, pos)
  normal = torch.einsum('bij,bnkj->bnki', rh, normal)
  return dist, pos, normal


def _hf_candidates(m: Model, d: Data, gh: int, pts_w, radius):
  """_hf_point_candidates of world-frame query points (B, n, ..., 3),
  flattened to (B, n, k) candidates a pair."""
  s = m.stat
  ph, rh = d.geom_xpos[:, gh], d.geom_xmat[:, gh]
  lead = (slice(None),) + (None,) * (pts_w.ndim - 2)
  pts = torch.einsum('bji,b...j->b...i', rh, pts_w - ph[lead])
  dist, pos, normal = _hf_point_candidates(
      m.hfield_data, s.hfield_size, s.hfield_nrow, s.hfield_ncol, pts,
      radius)
  B, n = pts_w.shape[:2]
  return (dist.reshape(B, n, -1), pos.reshape(B, n, -1, 3),
          normal.reshape(B, n, -1, 3))


def _hfield_sphere(m: Model, d: Data, g1s, g2s, npts):
  gh, t2 = int(g1s[0]), _ix(g2s, d.qpos.device)
  out = _hf_candidates(m, d, gh, d.geom_xpos[:, t2], m.geom_size[t2, 0])
  return _hf_select(d, gh, *out, npts)


def _hfield_capsule(m: Model, d: Data, g1s, g2s, npts):
  """Three sample spheres along the capsule's segment."""
  gh, t2 = int(g1s[0]), _ix(g2s, d.qpos.device)
  p = d.geom_xpos[:, t2]
  axis = d.geom_xmat[:, t2][..., :, 2]
  r, hl = m.geom_size[t2, 0], m.geom_size[t2, 1]
  ts = table(np.array([-1.0, 0.0, 1.0]), p.dtype, p.device)
  cs = p[..., None, :] + axis[..., None, :] * (ts[None, :, None]
                                               * hl[:, None, None])
  out = _hf_candidates(m, d, gh, cs, r[:, None].expand(len(g2s), 3))
  return _hf_select(d, gh, *out, npts)


def _hfield_box(m: Model, d: Data, g1s, g2s, npts):
  """The box's eight corners as spheres of radius zero."""
  gh, t2 = int(g1s[0]), _ix(g2s, d.qpos.device)
  p = d.geom_xpos[:, t2]
  mat = d.geom_xmat[:, t2]
  size = m.geom_size[t2]
  sign = table(_BOX_SIGNS, p.dtype, p.device)
  corners = p[..., None, :] + torch.einsum(
      'bnij,nkj->bnki', mat, sign[None] * size[:, None, :])
  out = _hf_candidates(m, d, gh, corners,
                       torch.zeros(len(g2s), 8, dtype=p.dtype,
                                   device=p.device))
  return _hf_select(d, gh, *out, npts)


_HF_COLLIDERS = {
    (GeomType.HFIELD, GeomType.SPHERE): _hfield_sphere,
    (GeomType.HFIELD, GeomType.CAPSULE): _hfield_capsule,
    (GeomType.HFIELD, GeomType.BOX): _hfield_box,
}


# ---------------------------------------------------------------------------
# Convex-solid pairs (ellipsoid and cylinder combinations) and mesh hulls.
#
# MuJoCo routes these through its general convex collider (MPR). The JAX
# engine finds the closest pair of the two solids by a fixed number of
# alternating projections (the projection onto a cylinder, box, ellipsoid
# or hull is closed-form or exact), with a support-direction estimate for
# deep overlap: distances agree with MuJoCo to ~1e-3 near contact, not to
# machine precision like the primitive pairs above. Every shape here is a
# (B, n, ...) batch of poses with (n, ...) shape parameters.
# ---------------------------------------------------------------------------


def _to_local(p, mat, x):
  return torch.einsum('...ji,...j->...i', mat, x - p)


def _to_world(p, mat, x):
  return p + torch.einsum('...ij,...j->...i', mat, x)


def _proj_ellipsoid_local(x, radii, iters: int = 12):
  """Closest point of a solid axis-aligned ellipsoid to x (its frame): x
  itself inside, else Newton on the Lagrange multiplier t."""
  r2 = radii * radii
  inside = ((x / radii) ** 2).sum(-1) <= 1.0
  t = ((torch.linalg.vector_norm(x, dim=-1) - radii.amin(-1)).clamp_min(0.0)
       * radii.amax(-1))
  a = r2 * x * x
  for _ in range(iters):
    denom = r2 + t[..., None]
    f = (a / (denom * denom)).sum(-1) - 1.0
    df = -2.0 * (a / denom ** 3).sum(-1)
    t = (t - f / torch.where(df.abs() > _MJMINVAL, df, -1.0)).clamp_min(0.0)
  y = r2 * x / (r2 + t[..., None])
  return torch.where(inside[..., None], x, y)


def _proj_cylinder_local(x, r, hl):
  """Closest point of a solid z-aligned cylinder to x (its frame)."""
  z = torch.minimum(torch.maximum(x[..., 2], -hl), hl)
  rad = x[..., :2]
  rn = torch.linalg.vector_norm(rad, dim=-1)
  scale = torch.minimum(rn, r) / rn.clamp_min(_MJMINVAL)
  return torch.cat([rad * scale[..., None], z[..., None]], -1)


def _proj_box_local(x, half):
  half = half.expand(x.shape)
  return torch.minimum(torch.maximum(x, -half), half)


def _supp_ellipsoid_local(n, radii):
  """The ellipsoid's support point in the local direction n."""
  v = radii * radii * n
  return v / torch.linalg.vector_norm(
      v / radii.clamp_min(_MJMINVAL), dim=-1,
      keepdim=True).clamp_min(_MJMINVAL)


def _supp_cylinder_local(n, r, hl):
  rad = n[..., :2]
  rn = torch.linalg.vector_norm(rad, dim=-1, keepdim=True).clamp_min(
      _MJMINVAL)
  return torch.cat([r[..., None] * rad / rn,
                    torch.sign(n[..., 2:3]) * hl[..., None]], -1)


def _supp_box_local(n, half):
  half = half.expand(n.shape)
  return torch.where(n >= 0, half, -half)


class _ConvexOps:
  """Support and projection of one convex shape family. `s` is an opaque
  per-pair shape parameter: geom_size for the analytic solids, a scale
  factor about the hull's centre for a mesh (shrinking a polytope about
  its centre erodes it exactly up to its faces' distance anisotropy)."""

  def __init__(self, proj, supp, inside, shrink, minext):
    self.proj = proj  # (p, mat, s, x_world) -> closest point of the solid
    self.supp = supp  # (p, mat, s, n_world) -> support point
    self.inside = inside  # (p, mat, s, x_world) -> x lies in the solid
    self.shrink = shrink  # (s, delta) -> eroded shape parameter
    self.minext = minext  # (s,) -> smallest half-extent


def _local_ops(proj_l, supp_l, inside_l) -> tuple:
  """(proj, supp, inside) in the world frame of local-frame functions of
  (x_local, s)."""
  proj = lambda p, mt, s, x: _to_world(p, mt, proj_l(_to_local(p, mt, x), s))
  supp = lambda p, mt, s, nw: _to_world(p, mt, supp_l(
      torch.einsum('...ji,...j->...i', mt, nw), s))
  inside = lambda p, mt, s, x: inside_l(_to_local(p, mt, x), s)
  return proj, supp, inside


def _inside_cylinder(x, s):
  return ((torch.linalg.vector_norm(x[..., :2], dim=-1) <= s[..., 0])
          & (x[..., 2].abs() <= s[..., 1]))


_SOLIDS = {
    GeomType.ELLIPSOID: (
        lambda x, s: _proj_ellipsoid_local(x, s[..., :3]),
        lambda n, s: _supp_ellipsoid_local(n, s[..., :3]),
        lambda x, s: ((x / s[..., :3]) ** 2).sum(-1) <= 1.0),
    GeomType.CYLINDER: (
        lambda x, s: _proj_cylinder_local(x, s[..., 0], s[..., 1]),
        lambda n, s: _supp_cylinder_local(n, s[..., 0], s[..., 1]),
        _inside_cylinder),
    GeomType.BOX: (
        lambda x, s: _proj_box_local(x, s[..., :3]),
        lambda n, s: _supp_box_local(n, s[..., :3]),
        lambda x, s: (x.abs() <= s[..., :3]).all(-1)),
}


def _shrink_size(gtype: int, s, delta):
  """Erode a solid's size by delta (Minkowski erosion: exact for a box or
  a cylinder, close for a mildly anisotropic ellipsoid)."""
  k = 2 if gtype == GeomType.CYLINDER else 3
  return torch.cat([s[..., :k] - delta[..., None], s[..., k:]], -1)


def _min_extent(gtype: int, s):
  if gtype == GeomType.CYLINDER:
    return torch.minimum(s[..., 0], s[..., 1])
  return s[..., :3].amin(-1)


def _ops_of(gtype: int) -> _ConvexOps:
  return _ConvexOps(*_local_ops(*_SOLIDS[gtype]),
                    lambda s, dlt: _shrink_size(gtype, s, dlt),
                    lambda s: _min_extent(gtype, s))


def _unit(v, dn):
  return v / dn.clamp_min(_MJMINVAL)[..., None]


def _unit_or_z(v):
  """v's unit direction, world +z where v vanishes."""
  vn = torch.linalg.vector_norm(v, dim=-1)
  ez = table(pmath._EZ, v.dtype, v.device).expand(v.shape)
  return torch.where((vn > _MJMINVAL)[..., None], _unit(v, vn), ez)


def _convex_core(ops1: _ConvexOps, ops2: _ConvexOps):
  """Collider of two convex shapes: erode both by a quarter of their
  smallest extent, find the closest pair of the eroded shapes (disjoint
  for any shallow penetration) by 48 alternating projections, and add the
  erosion back as the support-plane displacement along the found normal.
  Deeper overlap, the eroded shapes still overlapping, falls back to a
  support-direction depth along the centres' direction."""

  def collide(p1, m1, s1, p2, m2, s2):
    d1 = 0.25 * ops1.minext(s1)
    d2 = 0.25 * ops2.minext(s2)
    s1s = ops1.shrink(s1, d1)
    s2s = ops2.shrink(s2, d2)
    a, b = p1, p2
    for _ in range(48):
      a = ops1.proj(p1, m1, s1s, b)
      b = ops2.proj(p2, m2, s2s, a)
    delta = b - a
    dn = torch.linalg.vector_norm(delta, dim=-1)
    n_sep = _unit(delta, dn)
    # the exact support-plane displacement of each eroded shape along the
    # found normal (erosion by scaling moves a face far from the centre by
    # more than the nominal delta)
    e1 = ((ops1.supp(p1, m1, s1, n_sep) - ops1.supp(p1, m1, s1s, n_sep))
          * n_sep).sum(-1).clamp_min(0.0)
    e2 = ((ops2.supp(p2, m2, s2, -n_sep) - ops2.supp(p2, m2, s2s, -n_sep))
          * -n_sep).sum(-1).clamp_min(0.0)
    dist_sep = dn - e1 - e2
    pos_sep = 0.5 * (a + n_sep * e1[..., None] + b - n_sep * e2[..., None])
    # the eroded solids still overlap: deep penetration. The reference
    # tests the distance to each projection alone (< 1e-9), which float32
    # rounding of the frame changes defeats; the projections' own inside
    # tests decide the same in float64
    in_b = (ops2.inside(p2, m2, s2s, a) | (torch.linalg.vector_norm(
        ops2.proj(p2, m2, s2s, a) - a, dim=-1) < 1e-9))
    in_a = (ops1.inside(p1, m1, s1s, b) | (torch.linalg.vector_norm(
        ops1.proj(p1, m1, s1s, b) - b, dim=-1) < 1e-9))
    deep = in_a | in_b | (dn <= 1e-9)
    n_ov = _unit_or_z(p2 - p1)
    depth = ((ops1.supp(p1, m1, s1, n_ov) - ops2.supp(p2, m2, s2, -n_ov))
             * n_ov).sum(-1)
    n = torch.where(deep[..., None], n_ov, n_sep)
    dist = torch.where(deep, -torch.maximum(depth, d1 + d2), dist_sep)
    pos = torch.where(deep[..., None], 0.5 * (a + b), pos_sep)
    return dist[..., None], pos[..., None, :], n[..., None, :]

  return collide


def _capsule_convex_core(ops2: _ConvexOps):
  """Capsule (a rounded segment) against a convex shape."""

  def collide(p1, m1, s1, p2, m2, s2):
    r = s1[..., 0]
    a0, a1 = _capsule_ends(p1, m1, s1[..., 1])
    ab = a1 - a0
    abab = (ab * ab).sum(-1).clamp_min(_MJMINVAL)
    d2 = 0.25 * ops2.minext(s2)
    s2s = ops2.shrink(s2, d2)
    a, b = p1, p2
    for _ in range(48):
      t = ((b - a0) * ab).sum(-1) / abab
      a = a0 + t.clamp(0.0, 1.0)[..., None] * ab
      b = ops2.proj(p2, m2, s2s, a)
    delta = b - a
    dn = torch.linalg.vector_norm(delta, dim=-1)
    n = _unit(delta, dn)
    # the eroded shape's support-plane displacement (see _convex_core)
    e2 = ((ops2.supp(p2, m2, s2, -n) - ops2.supp(p2, m2, s2s, -n))
          * -n).sum(-1).clamp_min(0.0)
    dist = dn - r - e2
    pos = a + n * (r + 0.5 * dist)[..., None]
    # the segment's core inside the ERODED solid: deep penetration, the
    # centres' direction and the support depth past the near surface
    # (inside tests as in _convex_core)
    deep = (ops2.inside(p2, m2, s2s, a) | (torch.linalg.vector_norm(
        ops2.proj(p2, m2, s2s, a) - a, dim=-1) < 1e-9) | (dn <= 1e-9))
    cdir = p2 - p1
    n_ov = _unit(cdir, torch.linalg.vector_norm(cdir, dim=-1))
    delta_core = ((a - ops2.supp(p2, m2, s2, -n_ov)) * n_ov).sum(-1)
    n = torch.where(deep[..., None], n_ov, n)
    dist = torch.where(deep, -(r + torch.maximum(delta_core, d2)), dist)
    pos = torch.where(deep[..., None], a, pos)
    return dist[..., None], pos[..., None, :], n[..., None, :]

  return collide


def _sphere_ellipsoid(p1, m1, s1, p2, m2, s2):
  """Sphere against ellipsoid: the centre's Newton projection."""
  r = s1[..., 0]
  c = _proj_ellipsoid_local(_to_local(p2, m2, p1), s2[..., :3])
  dist, pos, n = _sphere_sphere_raw(p1, r, _to_world(p2, m2, c),
                                    torch.zeros_like(r))
  return dist[..., None], pos[..., None, :], n[..., None, :]


# ---------------------------------------------------------------------------
# Mesh (convex hull) narrowphase. The hulls are static (physics/mesh.py);
# a pair group gathers the hulls of its geoms into (n, V or F, ...)
# constants once per model, device and dtype, so support and the exact
# point-to-hull projection vectorize over the envs and pairs with fixed
# shapes. Mesh pairs go through the same erosion and alternating
# projection as the solids; plane-mesh and sphere-mesh are exact.
# ---------------------------------------------------------------------------


def _pick(x, idx):
  """x[..., idx, :] along x's candidate axis (..., K, 3), x broadcast to
  idx's leading shape; idx (...) int64."""
  x = x.expand(idx.shape + x.shape[-2:])
  return torch.gather(x, -2, idx[..., None, None].expand(
      idx.shape + (1, x.shape[-1])))[..., 0, :]


def _hull_inside(xu, H):
  """Whether the unscaled local point xu lies in the hull."""
  pl = (H['fnorm'] * xu[..., None, :]).sum(-1) - H['foff']
  return (torch.where(H['fmask'] > 0, pl, -1.0) <= 0).all(-1)


def _hull_closest(xu, H):
  """The closest point of the hull's surface to xu (first face on a tie,
  as jnp.argmin)."""
  tri = H['tri']
  cand, _ = _closest_on_triangle(xu[..., None, :], tri[..., 0, :],
                                 tri[..., 1, :], tri[..., 2, :])
  d2 = ((cand - xu[..., None, :]) ** 2).sum(-1)
  d2 = torch.where(H['fmask'] > 0, d2, torch.inf)
  return _pick(cand, d2.argmin(-1))


def _unscale(x, k, H):
  ctr = H['center']
  return ctr + (x - ctr) / k.clamp_min(_MJMINVAL)[..., None]


def _mesh_proj_local(x, k, H):
  """The closest point of the k-scaled hull to the local point x; x
  itself when inside."""
  ctr = H['center']
  xu = _unscale(x, k, H)  # unscale the query instead of the hull
  y = torch.where(_hull_inside(xu, H)[..., None], xu, _hull_closest(xu, H))
  return ctr + (y - ctr) * k[..., None]


def _mesh_supp_local(nl, k, H):
  """The hull's support point in the local direction nl, scaled by k."""
  dots = (H['vert'] * nl[..., None, :]).sum(-1)
  dots = torch.where(H['vmask'] > 0, dots, -torch.inf)
  v = _pick(H['vert'], dots.argmax(-1))
  return H['center'] + (v - H['center']) * k[..., None]


def _mesh_ops(H) -> _ConvexOps:
  """ConvexOps of a hull group; its shape parameter is a scale about the
  hull's centre (1.0 full size), which makes polytope erosion affine."""
  proj, supp, inside = _local_ops(
      lambda x, k: _mesh_proj_local(x, k, H),
      lambda n, k: _mesh_supp_local(n, k, H),
      lambda x, k: _hull_inside(_unscale(x, k, H), H))
  rin = H['rin'].clamp_min(_MJMINVAL)
  shrink = lambda k, dlt: (k - dlt / rin).clamp_min(0.05)
  minext = lambda k: k * H['rin']
  return _ConvexOps(proj, supp, inside, shrink, minext)


def _plane_mesh_fn(H):
  """Plane against hull: the signed plane distance of every hull vertex,
  the 4 deepest kept (the resting face's manifold, as _plane_box). The
  sort is stable: a resting face's vertices tie."""

  def collide(p1, m1, s1, p2, m2, s2):
    n = m1[..., :, 2]
    vw = p2[..., None, :] + torch.einsum('...ij,...vj->...vi', m2, H['vert'])
    cdist = ((vw - p1[..., None, :]) * n[..., None, :]).sum(-1)
    cdist = torch.where(H['vmask'] > 0, cdist, torch.inf)
    idx = torch.argsort(cdist, dim=-1, stable=True)[..., :4]
    dist = torch.take_along_dim(cdist, idx, dim=-1)
    pts = torch.take_along_dim(vw, idx[..., None], dim=-2)
    pos = pts - n[..., None, :] * (0.5 * dist)[..., None]
    return dist, pos, n[..., None, :].expand(pos.shape)

  return collide


def _sphere_mesh_fn(H):
  """Sphere against hull, exact: the centre's closest hull-surface point;
  a centre inside leaves through the nearest face."""

  def collide(p1, m1, s1, p2, m2, s2):
    r = s1[..., 0]
    cl = _to_local(p2, m2, p1)
    inside = _hull_inside(cl, H)
    delta = _to_world(p2, m2, _hull_closest(cl, H)) - p1
    dn = torch.linalg.vector_norm(delta, dim=-1)
    nd = _unit_or_z(delta)
    n = torch.where(inside[..., None], -nd, nd)
    dist = torch.where(inside, -(r + dn), dn - r)
    pos = p1 + n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]

  return collide


_HULL_KEYS = ('vert', 'vmask', 'tri', 'fnorm', 'foff', 'fmask', 'center',
              'rin')


def _hull_group(m: Model, gids: np.ndarray) -> dict:
  """The static hulls of the geoms `gids` as (n, ...) constants, uploaded
  once per model, device and dtype (physics/tables.table)."""
  s = m.stat
  if s.mesh_hulls is None:
    raise ValueError('a mesh pair group, but the model has no mesh hulls')
  mid = s.geom_dataid[gids]
  return {k: table(getattr(s.mesh_hulls, k)[mid], m.dtype, m.device)
          for k in _HULL_KEYS}


def _mesh_collider(m: Model, key, g1s, g2s):
  """(collider, s1, s2) of a pair group whose second geom (or both) is a
  mesh: GeomType orders MESH last."""
  t1 = key[0]
  H2 = _hull_group(m, g2s)
  ones = lambda g: table(np.ones(len(g)), m.dtype, m.device)
  size1 = m.geom_size[_ix(g1s, m.device)]
  if t1 == GeomType.PLANE:
    return _plane_mesh_fn(H2), size1, ones(g2s)
  if t1 == GeomType.SPHERE:
    return _sphere_mesh_fn(H2), size1, ones(g2s)
  if t1 == GeomType.CAPSULE:
    return _capsule_convex_core(_mesh_ops(H2)), size1, ones(g2s)
  if t1 == GeomType.MESH:
    return (_convex_core(_mesh_ops(_hull_group(m, g1s)), _mesh_ops(H2)),
            ones(g1s), ones(g2s))
  return _convex_core(_ops_of(t1), _mesh_ops(H2)), size1, ones(g2s)


_COLLIDERS.update({
    (GeomType.SPHERE, GeomType.ELLIPSOID): _sphere_ellipsoid,
    (GeomType.CAPSULE, GeomType.ELLIPSOID): _capsule_convex_core(
        _ops_of(GeomType.ELLIPSOID)),
    (GeomType.CAPSULE, GeomType.CYLINDER): _capsule_convex_core(
        _ops_of(GeomType.CYLINDER)),
    **{(a, b): _convex_core(_ops_of(a), _ops_of(b)) for a, b in (
        (GeomType.ELLIPSOID, GeomType.ELLIPSOID),
        (GeomType.ELLIPSOID, GeomType.CYLINDER),
        (GeomType.ELLIPSOID, GeomType.BOX),
        (GeomType.CYLINDER, GeomType.CYLINDER),
        (GeomType.CYLINDER, GeomType.BOX))},
})


def _mix_params(m: Model, g1: np.ndarray, g2: np.ndarray,
                pairids: np.ndarray):
  """Contact parameter combination (mj_contactParam); explicit <pair>
  slots take the pair_* fields verbatim. Per pair and shared by all envs,
  except friction where `geom_friction` carries a leading env axis (per-env
  domain randomization): then it is (B, npair, 5)."""
  s = m.stat
  dev = m.device
  p1 = s.geom_priority[g1]
  p2 = s.geom_priority[g2]
  t1, t2 = _ix(g1, dev), _ix(g2, dev)
  f1, f2 = m.geom_friction[..., t1, :], m.geom_friction[..., t2, :]
  sr1, sr2 = m.geom_solref[t1], m.geom_solref[t2]
  si1, si2 = m.geom_solimp[t1], m.geom_solimp[t2]
  mix1, mix2 = m.geom_solmix[t1], m.geom_solmix[t2]

  denom = mix1 + mix2
  half = torch.full_like(mix1, 0.5)
  w1 = torch.where(denom > _MJMINVAL, mix1 / denom.clamp_min(_MJMINVAL),
                   half)
  lo1, lo2 = mix1 < _MJMINVAL, mix2 < _MJMINVAL
  w1 = torch.where(lo1 & lo2, half, w1)
  w1 = torch.where(lo1 & ~lo2, torch.zeros_like(w1), w1)
  w1 = torch.where(~lo1 & lo2, torch.ones_like(w1), w1)
  w2 = 1.0 - w1
  solref_mix = torch.where(
      (sr1[:, :1] > 0) & (sr2[:, :1] > 0),
      w1[:, None] * sr1 + w2[:, None] * sr2, torch.minimum(sr1, sr2))
  solimp_mix = w1[:, None] * si1 + w2[:, None] * si2
  fric_mix = torch.maximum(f1, f2)

  use1 = table((p1 > p2)[:, None], torch.bool, dev)
  use2 = table((p2 > p1)[:, None], torch.bool, dev)
  eq = ~(use1 | use2)
  solref = torch.where(eq, solref_mix, torch.where(use1, sr1, sr2))
  solimp = torch.where(eq, solimp_mix, torch.where(use1, si1, si2))
  fric3 = torch.where(eq, fric_mix, torch.where(use1, f1, f2))
  friction = torch.stack([fric3[..., 0], fric3[..., 0], fric3[..., 1],
                          fric3[..., 2], fric3[..., 2]], -1)
  # includemargin == margin (MuJoCo's gap has no observable effect)
  margin = torch.maximum(m.geom_margin[t1], m.geom_margin[t2])

  if (pairids >= 0).any():
    is_pair = table(pairids >= 0, torch.bool, dev)
    pid = _ix(np.maximum(pairids, 0), dev)
    friction = torch.where(is_pair[:, None], m.pair_friction[pid], friction)
    solref = torch.where(is_pair[:, None], m.pair_solref[pid], solref)
    solimp = torch.where(is_pair[:, None], m.pair_solimp[pid], solimp)
    margin = torch.where(is_pair, m.pair_margin[pid], margin)
  return friction, solref, solimp, margin


def group_collider(m: Model, key, g1s, g2s):
  """The narrowphase of one pair group of analytic or mesh geoms, as a
  function of the Data: (dist, pos, normal[, first tangent]), each with
  the group's (B, n, npts) leading shape."""
  dev = m.device
  t1, t2 = _ix(g1s, dev), _ix(g2s, dev)
  if GeomType.MESH in key:
    fn, s1, s2 = _mesh_collider(m, key, g1s, g2s)
  else:
    fn, s1, s2 = _COLLIDERS[key], m.geom_size[t1], m.geom_size[t2]
  return lambda d: fn(d.geom_xpos[:, t1], d.geom_xmat[:, t1], s1,
                      d.geom_xpos[:, t2], d.geom_xmat[:, t2], s2)


def collision(m: Model, d: Data) -> Data:
  """Run all narrowphase groups; fill the fixed-capacity contact set."""
  s = m.stat
  if s.pairs.ncon_max == 0:
    return d
  B = d.qpos.shape[0]
  con = d.contact
  dist = con.dist.clone()
  pos = con.pos.clone()
  frame = con.frame.clone()
  friction = con.friction.clone()
  solref = con.solref.clone()
  solimp = con.solimp.clone()
  includemargin = con.includemargin.clone()

  for key, (g1s, g2s, pids, base, npts) in s.pairs.groups.items():
    n = len(g1s)
    if key in _HF_COLLIDERS:
      out = _HF_COLLIDERS[key](m, d, g1s, g2s, npts)
    else:
      out = group_collider(m, key, g1s, g2s)(d)
    cd = out[0].reshape(B, n * npts)
    cp = out[1].reshape(B, n * npts, 3)
    cn = out[2].reshape(B, n * npts, 3)
    if len(out) > 3:  # collider-provided first tangent
      ct1 = out[3].reshape(B, n * npts, 3)
      fr = torch.stack([cn, ct1, pmath.cross(cn, ct1)], dim=-2)
    else:
      fr = pmath.make_tangent_frame(cn)

    fric, sr, si, inc = _mix_params(m, g1s, g2s, pids)
    rep = lambda x: torch.repeat_interleave(x, npts, dim=0)
    sl = slice(base, base + n * npts)
    dist[:, sl] = cd
    pos[:, sl] = cp
    frame[:, sl] = fr
    friction[:, sl] = torch.repeat_interleave(fric, npts, dim=-2)
    solref[:, sl] = rep(sr)
    solimp[:, sl] = rep(si)
    includemargin[:, sl] = rep(inc)

  con = con.replace(dist=dist, pos=pos, frame=frame, friction=friction,
                    solref=solref, solimp=solimp,
                    includemargin=includemargin)
  ncon_active = (dist < includemargin).sum(-1).to(torch.int32)
  return d.replace(contact=con, ncon_active=ncon_active)
