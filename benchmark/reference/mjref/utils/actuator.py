"""Electric actuator parameters: reflected inertia and PD gains.

Counterpart of mjlab_tpu/utils/actuator.py. An actuator's armature is the
rotor inertia reflected through the gear train, and its PD gains follow
from a natural frequency and a damping ratio on that inertia:
kp = armature * omega^2, kd = 2 * zeta * armature * omega.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ElectricActuator:
  reflected_inertia: float
  velocity_limit: float
  effort_limit: float

  def pd_gains(self, natural_freq_hz: float = 10.0,
               damping_ratio: float = 2.0) -> 'tuple[float, float]':
    """kp = armature * omega^2, kd = 2 * zeta * armature * omega."""
    omega = 2.0 * math.pi * natural_freq_hz
    kp = self.reflected_inertia * omega ** 2
    kd = 2.0 * damping_ratio * self.reflected_inertia * omega
    return kp, kd


def reflected_inertia(rotor_inertia: float, gear_ratio: float) -> float:
  """A single-stage gearbox: rotor inertia times the ratio squared."""
  return rotor_inertia * gear_ratio ** 2


def reflected_inertia_two_stage_planetary(rotor_inertia, gear_ratio):
  """Each element's inertia reflected through the downstream ratios
  (gear_ratio[0] is the rotor itself, = 1)."""
  assert gear_ratio[0] == 1
  return (rotor_inertia[0] * (gear_ratio[1] * gear_ratio[2]) ** 2
          + rotor_inertia[1] * gear_ratio[2] ** 2 + rotor_inertia[2])


