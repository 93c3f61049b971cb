"""Quaternion and spatial-vector math on batched tensors.

Counterpart of mjlab_tpu/physics/math.py. Conventions follow MuJoCo:
quaternions are (w, x, y, z); spatial motion vectors are (angular[3],
linear[3]); spatial force vectors are (torque[3], force[3]). Every function
broadcasts over leading axes.
"""

from __future__ import annotations

import numpy as np
import torch

from mjref.physics.tables import table

_CONJ = np.array([1.0, -1.0, -1.0, -1.0])
_EY = np.array([0.0, 1.0, 0.0])
_EZ = np.array([0.0, 0.0, 1.0])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Cross product over the last axis, with broadcasting."""
  a, b = torch.broadcast_tensors(a, b)
  return torch.linalg.cross(a, b, dim=-1)


def mul_quat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Hamilton product a*b."""
  aw, ax, ay, az = a.unbind(-1)
  bw, bx, by, bz = b.unbind(-1)
  return torch.stack([
      aw * bw - ax * bx - ay * by - az * bz,
      aw * bx + ax * bw + ay * bz - az * by,
      aw * by - ax * bz + ay * bw + az * bx,
      aw * bz + ax * by - ay * bx + az * bw,
  ], dim=-1)


def neg_quat(q: torch.Tensor) -> torch.Tensor:
  """Conjugate (inverse for unit quaternions)."""
  return q * table(_CONJ, q.dtype, q.device)


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
  norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
  ident = torch.zeros_like(q)
  ident[..., 0] = 1.0
  return torch.where(norm > 1e-12, q / norm.clamp_min(1e-12), ident)


def rot_vec_quat(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """Rotate vector v by quaternion q (active rotation)."""
  w = q[..., :1]
  u = q[..., 1:]
  uv = cross(u, v)
  return v + 2.0 * (w * uv + cross(u, uv))


def rot_vec_quat_inv(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
  """Rotate vector v by the inverse of quaternion q."""
  return rot_vec_quat(v, neg_quat(q))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
  """Unit quaternion -> 3x3 rotation matrix."""
  w, x, y, z = q.unbind(-1)
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  m = torch.stack([
      1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
      2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
      2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
  ], dim=-1)
  return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor
                       ) -> torch.Tensor:
  half = angle * 0.5
  return torch.cat([torch.cos(half)[..., None],
                    axis * torch.sin(half)[..., None]], dim=-1)


def quat_integrate(q: torch.Tensor, vel: torch.Tensor, dt) -> torch.Tensor:
  """q <- q * exp(vel*dt/2), vel in the local frame (mju_quatIntegrate)."""
  angle = torch.linalg.vector_norm(vel, dim=-1)
  axis = vel / angle.clamp_min(1e-12)[..., None]
  dq = axis_angle_to_quat(axis, angle * dt)
  ident = torch.zeros_like(dq)
  ident[..., 0] = 1.0
  dq = torch.where((angle > 1e-12)[..., None], dq, ident)
  return normalize_quat(mul_quat(q, dq))


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
  """Rotational velocity taking qb to qa in unit time, in qb's local frame
  (mju_subQuat)."""
  q = mul_quat(neg_quat(qb), qa)
  q = torch.where(q[..., :1] < 0, -q, q)
  sin_half = torch.linalg.vector_norm(q[..., 1:], dim=-1)
  angle = 2.0 * torch.atan2(sin_half, q[..., 0])
  axis = q[..., 1:] / sin_half.clamp_min(1e-12)[..., None]
  return torch.where((sin_half > 1e-12)[..., None], axis * angle[..., None],
                     2.0 * q[..., 1:])


def motion_cross(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
  """Spatial motion cross product v x u (mju_crossMotion)."""
  vang, vlin = v[..., :3], v[..., 3:]
  uang, ulin = u[..., :3], u[..., 3:]
  return torch.cat([cross(vang, uang),
                    cross(vang, ulin) + cross(vlin, uang)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
  """Spatial force cross product v x* f (mju_crossForce)."""
  vang, vlin = v[..., :3], v[..., 3:]
  ftrq, ffrc = f[..., :3], f[..., 3:]
  return torch.cat([cross(vang, ftrq) + cross(vlin, ffrc),
                    cross(vang, ffrc)], dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
  """Skew-symmetric cross-product matrix."""
  x, y, z = v.unbind(-1)
  zero = torch.zeros_like(x)
  m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
  return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, inertia_mat: torch.Tensor,
                    com_offset: torch.Tensor) -> torch.Tensor:
  """6x6 spatial inertia about a frame displaced by -com_offset from the
  COM: f = [I*w + h x v ; m*v - h x w], h = m * com_offset."""
  m = mass[..., None, None]
  h = mass[..., None] * com_offset
  hhat = hat(h)
  eye = torch.eye(3, dtype=h.dtype, device=h.device).expand(hhat.shape)
  icom = inertia_mat + (hhat @ hhat.transpose(-1, -2)) / m.clamp_min(1e-12)
  top = torch.cat([icom, hhat], dim=-1)
  bot = torch.cat([-hhat, m * eye], dim=-1)
  return torch.cat([top, bot], dim=-2)


def closest_segment_point(a, b, pt):
  """Closest point on segment [a, b] to pt."""
  ab = b - a
  t = (((pt - a) * ab).sum(-1)
       / (ab * ab).sum(-1).clamp_min(1e-12))
  return a + t.clamp(0.0, 1.0)[..., None] * ab


def closest_segment_segment(a0, a1, b0, b1):
  """Closest points between two segments. Returns (pa, pb)."""
  d1 = a1 - a0
  d2 = b1 - b0
  r = a0 - b0
  A = (d1 * d1).sum(-1)
  e = (d2 * d2).sum(-1)
  f = (d2 * r).sum(-1)
  c = (d1 * r).sum(-1)
  b = (d1 * d2).sum(-1)
  denom = A * e - b * b
  s = torch.where(denom > 1e-12,
                  ((b * f - c * e) / denom.clamp_min(1e-12)).clamp(0, 1),
                  torch.zeros_like(denom))
  t = (b * s + f) / e.clamp_min(1e-12)
  t_clamped = t.clamp(0.0, 1.0)
  s = ((b * t_clamped - c) / A.clamp_min(1e-12)).clamp(0.0, 1.0)
  return a0 + d1 * s[..., None], b0 + d2 * t_clamped[..., None]


def make_tangent_frame(normal: torch.Tensor) -> torch.Tensor:
  """Contact frame rows (normal, tangent1, tangent2) from a unit normal,
  matching mju_makeFrame."""
  n = normal
  near_z = n[..., 2].abs() > 0.9
  ey = table(_EY, n.dtype, n.device).expand(n.shape)
  ez = table(_EZ, n.dtype, n.device).expand(n.shape)
  ref = torch.where(near_z[..., None], ey, ez)
  t1 = ref - n * (n * ref).sum(-1, keepdim=True)
  t1 = t1 / torch.linalg.vector_norm(t1, dim=-1, keepdim=True).clamp_min(
      1e-12)
  t2 = cross(n, t1)
  return torch.stack([n, t1, t2], dim=-2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
  """3x3 rotation matrix -> unit quaternion (w, x, y, z), w >= 0: of the
  four constructions, the one of the largest pivot (branchless)."""
  m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
  m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
  m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
  qw = torch.stack([1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                    1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
  case = torch.argmax(qw, dim=-1, keepdim=True)
  s = torch.sqrt(torch.gather(qw, -1, case)[..., 0].clamp_min(1e-12)) * 2.0
  cands = torch.stack([
      torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                   (m10 - m01) / s], -1),
      torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                   (m02 + m20) / s], -1),
      torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                   (m12 + m21) / s], -1),
      torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                   0.25 * s], -1),
  ], dim=-2)
  q = torch.gather(cands, -2, case[..., None].expand(
      case.shape[:-1] + (1, 4)))[..., 0, :]
  return normalize_quat(torch.where(q[..., :1] < 0, -q, q))


