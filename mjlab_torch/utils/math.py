"""Task-level batched math (quaternions, frames, samplers).

Counterpart of mjlab_tpu/utils/math.py, holding what the environment layer
calls. Quaternions are (w, x, y, z); every function broadcasts over leading
axes. Samplers draw from an explicit `torch.Generator` that lives on the
device of the result.
"""

from __future__ import annotations

import math

import torch

from mjlab_torch.physics.math import mul_quat as quat_mul  # noqa: F401
from mjlab_torch.physics.math import neg_quat as quat_conjugate
from mjlab_torch.physics.math import normalize_quat as quat_normalize
from mjlab_torch.physics.math import quat_to_mat as matrix_from_quat  # noqa
from mjlab_torch.physics.math import rot_vec_quat


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector(s) v by quaternion(s) q."""
  return rot_vec_quat(v, q)


def quat_apply_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """Rotate vector(s) v by the inverse of quaternion(s) q."""
  return rot_vec_quat(v, quat_conjugate(q))


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


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
  return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def sample_uniform(gen: torch.Generator, lo, hi, shape, dtype=torch.float32
                   ) -> torch.Tensor:
  """Uniform on [lo, hi) as lo + (hi - lo) * u, so a range collapsed to a
  point gives exactly that point. The result lives on `gen`'s device."""
  u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
  return lo + (hi - lo) * u


def sample_log_uniform(gen: torch.Generator, lo, hi, shape,
                       dtype=torch.float32) -> torch.Tensor:
  return torch.exp(sample_uniform(gen, math.log(lo), math.log(hi), shape,
                                  dtype))


def sample_gaussian(gen: torch.Generator, mean, std, shape,
                    dtype=torch.float32) -> torch.Tensor:
  return mean + std * torch.randn(shape, generator=gen, dtype=dtype,
                                  device=gen.device)
