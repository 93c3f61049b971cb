"""Dispatch of the fused smooth stage (kernel K3, ops/smooth_kernel.py).

`smooth_all(m, d)` computes kinematics + com_pos + com_vel + crb + rne in
one stage. Counterpart of mjlab_tpu/physics/smooth_fused.py. A batch on a
CUDA device launches the kernel; a batch on the CPU runs `plain_all`, the
stages the kernel replaces. Models outside the kernel's class (see
`_Tree.supported`) run the stages one by one in physics/pipeline.py.
"""

from __future__ import annotations

from mjlab_torch.ops import smooth_kernel as _sk
from mjlab_torch.physics import kinematics as _kinematics
from mjlab_torch.physics import smooth as _smooth
from mjlab_torch.physics.types import Data, Model


def enabled(stat) -> bool:
  """Model-class gate of the fused stage."""
  return _sk._Tree.supported(stat)


def plain_all(m: Model, d: Data) -> Data:
  """K3's plain version: the stages the kernel fuses, in torch."""
  d = _kinematics.kinematics(m, d)
  d = _kinematics.com_pos(m, d)
  d = _kinematics.com_vel(m, d)
  d = _smooth.crb(m, d)
  return _smooth.rne(m, d)


def smooth_all(m: Model, d: Data) -> Data:
  if d.qpos.device.type == 'cpu':
    return plain_all(m, d)
  res = _sk.smooth_fused_cuda(m, d.qpos.contiguous(), d.qvel.contiguous())
  if not m.stat.nsite:
    res['site_xpos'] = d.site_xpos
    res['site_xmat'] = d.site_xmat
  return d.replace(**res)
