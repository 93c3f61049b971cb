"""Task-level batched math (quaternions, frames, samplers).

Counterpart of mjlab_tpu/utils/math.py, holding what the environment layer
calls. Quaternions are (w, x, y, z); every function broadcasts over leading
axes. Samplers draw from an explicit `torch.Generator` that lives on the
device of the result.
"""

from __future__ import annotations

import math

import torch

from mjref.physics.math import (  # noqa: F401  (re-exported)
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
  u = torch.rand(tuple(shape), generator=gen, dtype=dtype, device=gen.device)
  return lo + (hi - lo) * u


def sample_log_uniform(gen: torch.Generator, lo, hi, shape,
                       dtype=torch.float32) -> torch.Tensor:
  return torch.exp(sample_uniform(gen, math.log(lo), math.log(hi), shape,
                                  dtype))


def sample_gaussian(gen: torch.Generator, mean, std, shape,
                    dtype=torch.float32) -> torch.Tensor:
  return mean + std * torch.randn(tuple(shape), generator=gen, dtype=dtype,
                                  device=gen.device)
