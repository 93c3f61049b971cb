"""The fused smooth stage: the stages that the port's kernel K3 fuses,
in plain torch.

`smooth_all(m, d)` computes kinematics + com_pos + com_vel + crb + rne in
one stage, for the models in K3's class (`enabled`: one FREE root joint,
at most one HINGE or SLIDE joint on every other body, no mocap bodies).
Counterpart of mjlab_tpu/physics/smooth_fused.py. Models outside the
class run the stages one by one in physics/pipeline.py.
"""

from __future__ import annotations

import numpy as np

from mjref.physics import kinematics as _kinematics
from mjref.physics import smooth as _smooth
from mjref.physics.types import Data, JointType, Model


def enabled(s) -> bool:
  """Model-class gate of the fused stage (K3's)."""
  if s.nmocap:
    return False
  jnt_per_body = np.zeros(s.nbody, np.int32)
  for j in range(int(s.njnt)):
    jnt_per_body[int(s.jnt_bodyid[j])] += 1
  if (jnt_per_body > 1).any():
    return False
  for j in range(int(s.njnt)):
    t = int(s.jnt_type[j])
    b = int(s.jnt_bodyid[j])
    if t == int(JointType.FREE):
      if int(s.body_parentid[b]) != 0:
        return False
    elif t not in (int(JointType.HINGE), int(JointType.SLIDE)):
      return False
  return True


def plain_all(m: Model, d: Data) -> Data:
  """K3's plain version: the stages the kernel fuses, in torch."""
  d = _kinematics.kinematics(m, d)
  d = _kinematics.com_pos(m, d)
  d = _kinematics.com_vel(m, d)
  d = _smooth.crb(m, d)
  return _smooth.rne(m, d)


def smooth_all(m: Model, d: Data) -> Data:
  return plain_all(m, d)
