"""Narrowphase collision over the static pair table, on a batch of envs.

Counterpart of mjlab_tpu/physics/collision.py. Broadphase is resolved when
the model is built (io._build_pairs); each pair group is one vectorized
narrowphase call producing a fixed number of candidate contacts per pair.
Inactive candidates keep dist >= includemargin and are masked out of the
constraint rows.

Implemented colliders: plane-sphere, plane-capsule, plane-box,
sphere-sphere, sphere-capsule and capsule-capsule (the pairs of the
Unitree G1 and Go1 scenes). Any other pair raises NotImplementedError
naming it.

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


_COLLIDERS = {
    (GeomType.PLANE, GeomType.SPHERE): _plane_sphere,
    (GeomType.PLANE, GeomType.CAPSULE): _plane_capsule,
    (GeomType.PLANE, GeomType.BOX): _plane_box,
    (GeomType.SPHERE, GeomType.SPHERE): _sphere_sphere,
    (GeomType.SPHERE, GeomType.CAPSULE): _sphere_capsule,
    (GeomType.CAPSULE, GeomType.CAPSULE): _capsule_capsule,
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
    fn = _COLLIDERS.get(key)
    if fn is None:
      raise NotImplementedError(
          f'collision pair {GeomType(key[0]).name}-{GeomType(key[1]).name} '
          'is not implemented in mjlab_torch yet')
    n = len(g1s)
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
