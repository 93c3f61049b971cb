"""Narrowphase collision over the static pair table, on a batch of envs.

Counterpart of mjlab_tpu/physics/collision.py. Broadphase is resolved when
the model is built (io._build_pairs); each pair group is one vectorized
narrowphase call producing a fixed number of candidate contacts per pair.
Inactive candidates keep dist >= includemargin and are masked out of the
constraint rows.

Implemented colliders: plane-sphere, plane-capsule, plane-box,
sphere-sphere, sphere-capsule and capsule-capsule (the pairs of the
Unitree G1 and Go1 scenes), sphere-box, capsule-box and box-box (the
pairs of the engine's oracle models of equality constraints and tendons),
and heightfield-sphere, -capsule and -box (the same robots on generated
rough terrain). Any other pair raises
NotImplementedError naming it.

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


def collision(m: Model, d: Data) -> Data:
  """Run all narrowphase groups; fill the fixed-capacity contact set."""
  s = m.stat
  if s.pairs.ncon_max == 0:
    return d
  dev = d.qpos.device
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
      fn = _COLLIDERS.get(key)
      if fn is None:
        raise NotImplementedError(
            f'collision pair {GeomType(key[0]).name}-'
            f'{GeomType(key[1]).name} is not implemented in mjlab_torch yet')
      t1, t2 = _ix(g1s, dev), _ix(g2s, dev)
      out = fn(d.geom_xpos[:, t1], d.geom_xmat[:, t1], m.geom_size[t1],
               d.geom_xpos[:, t2], d.geom_xmat[:, t2], m.geom_size[t2])
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
