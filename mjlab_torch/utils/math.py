"""Task-level batched math (quaternions, frames, samplers).

Counterpart of mjlab_tpu/utils/math.py, holding what the environment layer
calls. Quaternions are (w, x, y, z); every function broadcasts over leading
axes. Samplers draw from an explicit `torch.Generator` that lives on the
device of the result; a sharded env's generator draws the whole env axis
and keeps its rows (`ShardedGenerator`, `env_rows`).
"""

from __future__ import annotations

import math

import torch

from mjlab_torch.physics.math import (  # noqa: F401  (re-exported)
    axis_angle_to_quat,
    mat_to_quat,
    mul_quat as quat_mul,
    neg_quat as quat_conjugate,
    normalize_quat as quat_normalize,
    quat_to_mat as matrix_from_quat,
    rot_vec_quat,
    rot_vec_quat_inv,
)


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector(s) v by quaternion(s) q."""
  return rot_vec_quat(v, q)


def quat_apply_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector(s) v by the inverse of quaternion(s) q."""
  return rot_vec_quat_inv(v, q)


# the names isaaclab gives them
quat_rotate = quat_apply
quat_rotate_inverse = quat_apply_inverse


def quat_inv(q: torch.Tensor) -> torch.Tensor:
  return quat_conjugate(quat_normalize(q))


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
  """The yaw-only part of q: (w, 0, 0, z) / |(w, z)|, the norm guarded at
  1e-6 (the square at 1e-12)."""
  w, z = q[..., 0], q[..., 3]
  norm = torch.sqrt(torch.clamp_min(w * w + z * z, 1e-12))
  zero = torch.zeros_like(w)
  return torch.stack([w / norm, zero, zero, z / norm], dim=-1)


def quat_error_magnitude(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """Rotation angle between two quaternions."""
  dq = quat_mul(q1, quat_conjugate(q2))
  sin_half = torch.linalg.vector_norm(dq[..., 1:], dim=-1)
  return 2.0 * torch.atan2(sin_half, dq[..., 0].abs())


def combine_frame_transforms(p1, q1, p2=None, q2=None):
  """T_world = T1 * T2: (p1, q1) composed with the child offset (p2, q2)."""
  p = p1 if p2 is None else p1 + quat_apply(q1, p2)
  q = q1 if q2 is None else quat_mul(q1, q2)
  return p, q


def subtract_frame_transforms(p1, q1, p2=None, q2=None):
  """T_12 = T1^-1 * T2: frame 2 expressed in frame 1."""
  q1_inv = quat_conjugate(q1)
  p = quat_apply(q1_inv, -p1 if p2 is None else p2 - p1)
  q = q1_inv if q2 is None else quat_mul(q1_inv, q2)
  return p, q


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
  """Intrinsic XYZ euler angles -> quaternion."""
  cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
  cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
  cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
  return torch.stack([
      cy * cp * cr + sy * sp * sr,
      cy * cp * sr - sy * sp * cr,
      cy * sp * cr + sy * cp * sr,
      sy * cp * cr - cy * sp * sr,
  ], dim=-1)


def euler_xyz_from_quat(q: torch.Tensor):
  """Quaternion -> (roll, pitch, yaw), intrinsic XYZ."""
  w, x, y, z = q.unbind(-1)
  roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
  pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
  yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
  return roll, pitch, yaw


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
  """Spherical interpolation along the shorter arc; `t` a number or a
  tensor of the batch shape."""
  d = (q0 * q1).sum(-1, keepdim=True)
  q1 = torch.where(d < 0, -q1, q1)
  d = d.abs()
  theta = torch.acos(d.clamp(-1.0, 1.0))
  sin_t = torch.sin(theta)
  if torch.is_tensor(t) and t.ndim:
    t = t[..., None]
  safe = sin_t.clamp_min(1e-12)
  w0 = torch.where(sin_t > 1e-6, torch.sin((1 - t) * theta) / safe, 1 - t)
  w1 = torch.where(sin_t > 1e-6, torch.sin(t * theta) / safe, t)
  return quat_normalize(w0 * q0 + w1 * q1)


def quat_box_minus(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
  """The rotation vector taking q2 to q1 (the log map)."""
  dq = quat_mul(quat_conjugate(q2), q1)
  dq = torch.where(dq[..., :1] < 0, -dq, dq)
  sin_half = torch.linalg.vector_norm(dq[..., 1:], dim=-1)
  angle = 2.0 * torch.atan2(sin_half, dq[..., 0])
  axis = dq[..., 1:] / sin_half.clamp_min(1e-12)[..., None]
  return torch.where((sin_half > 1e-7)[..., None], axis * angle[..., None],
                     2.0 * dq[..., 1:])


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
  return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


class ShardedGenerator(torch.Generator):
  """The generator of one rank of a sharded env or learner
  (parallel/sharding.py). Seeded alike on every rank, it draws the whole
  env axis wherever a draw has one, so that env i draws what it draws in
  one process, and keeps the rank's rows: `rows` is (offset, n_local,
  num_envs). The ranks' generators stay in lockstep; each draw costs the
  random numbers of every rank's envs."""

  def __new__(cls, device, rows: 'tuple[int, int, int]'):
    return super().__new__(cls, device)

  def __init__(self, device, rows: 'tuple[int, int, int]'):
    self.rows = rows


def env_rows(gen: torch.Generator, draw, shape) -> torch.Tensor:
  """`draw(shape)`, where a leading axis of the rank's env count is the
  env axis: with a ShardedGenerator it is drawn at the global env count and
  cut to the rank's rows."""
  shape = tuple(shape)
  rows = getattr(gen, 'rows', None)
  if rows is None or not shape or shape[0] != rows[1] or rows[1] == rows[2]:
    return draw(shape)
  offset, n, total = rows
  return draw((total,) + shape[1:])[offset:offset + n].clone()


def sample_uniform(gen: torch.Generator, lo, hi, shape, dtype=torch.float32
                   ) -> torch.Tensor:
  """Uniform on [lo, hi) as lo + (hi - lo) * u, so a range collapsed to a
  point gives exactly that point. The result lives on `gen`'s device; a
  leading env axis draws as env_rows says."""
  u = env_rows(gen, lambda s: torch.rand(s, generator=gen, dtype=dtype,
                                         device=gen.device), shape)
  return lo + (hi - lo) * u


def sample_log_uniform(gen: torch.Generator, lo, hi, shape,
                       dtype=torch.float32) -> torch.Tensor:
  return torch.exp(sample_uniform(gen, math.log(lo), math.log(hi), shape,
                                  dtype))


def sample_gaussian(gen: torch.Generator, mean, std, shape,
                    dtype=torch.float32) -> torch.Tensor:
  return mean + std * env_rows(
      gen, lambda s: torch.randn(s, generator=gen, dtype=dtype,
                                 device=gen.device), shape)
