"""Unitree G1 humanoid (29 DoF): the motors, the per-joint action scale,
the foot geoms and the entity configuration.

Counterpart of mjlab_tpu/asset_zoo/unitree_g1.py without the spec path:
the robot's compiled model comes from the G1 flat snapshot
(asset_zoo/__init__.py), which holds its actuators, collision properties
and sensors. The motors' PD gains (10 Hz natural frequency, damping ratio
2, on the rotor inertia reflected through the two-stage planetary gear
train) set the per-joint action scale.
"""

from __future__ import annotations

from mjref.entity.entity import EntityCfg, EntityInitStateCfg
from mjref.utils.actuator import (
    ElectricActuator,
    reflected_inertia_two_stage_planetary,
)

# motors (public Unitree specs)
ARMATURE_5020 = reflected_inertia_two_stage_planetary(
    (0.139e-4, 0.017e-4, 0.169e-4), (1, 1 + 46 / 18, 1 + 56 / 16))
ARMATURE_7520_14 = reflected_inertia_two_stage_planetary(
    (0.489e-4, 0.098e-4, 0.533e-4), (1, 4.5, 1 + 48 / 22))
ARMATURE_7520_22 = reflected_inertia_two_stage_planetary(
    (0.489e-4, 0.109e-4, 0.738e-4), (1, 4.5, 5))
ARMATURE_4010 = reflected_inertia_two_stage_planetary(
    (0.068e-4, 0.0, 0.0), (1, 5, 5))

ACTUATOR_5020 = ElectricActuator(ARMATURE_5020, 37.0, 25.0)
ACTUATOR_7520_14 = ElectricActuator(ARMATURE_7520_14, 32.0, 88.0)
ACTUATOR_7520_22 = ElectricActuator(ARMATURE_7520_22, 20.0, 139.0)
ACTUATOR_4010 = ElectricActuator(ARMATURE_4010, 22.0, 5.0)


def _scale(names, act: ElectricActuator, mult: float = 1.0) -> dict:
  """0.25 * effort / kp for each joint expression of one motor group."""
  kp, _ = act.pd_gains()
  effort, stiffness = act.effort_limit * mult, kp * mult
  return {expr: 0.25 * effort / stiffness for expr in names} if stiffness \
      else {}


# per-joint action scale 0.25 * effort / kp; waist pitch/roll and ankles
# are 4-bar linkages driven by two 5020s (nominal 1:1, so the pair sums)
G1_ACTION_SCALE: 'dict[str, float]' = {
    **_scale(['.*_elbow_joint', '.*_shoulder_pitch_joint',
              '.*_shoulder_roll_joint', '.*_shoulder_yaw_joint',
              '.*_wrist_roll_joint'], ACTUATOR_5020),
    **_scale(['.*_hip_pitch_joint', '.*_hip_yaw_joint', 'waist_yaw_joint'],
             ACTUATOR_7520_14),
    **_scale(['.*_hip_roll_joint', '.*_knee_joint'], ACTUATOR_7520_22),
    **_scale(['.*_wrist_pitch_joint', '.*_wrist_yaw_joint'], ACTUATOR_4010),
    **_scale(['waist_pitch_joint', 'waist_roll_joint'], ACTUATOR_5020,
             mult=2.0),
    **_scale(['.*_ankle_pitch_joint', '.*_ankle_roll_joint'], ACTUATOR_5020,
             mult=2.0),
}

FOOT_REGEX = r'^(left|right)_foot[1-7]_collision$'

KNEES_BENT_KEYFRAME = EntityInitStateCfg(
    pos=(0.0, 0.0, 0.76),
    joint_pos={
        '.*_hip_pitch_joint': -0.312,
        '.*_knee_joint': 0.669,
        '.*_ankle_pitch_joint': -0.363,
        '.*_elbow_joint': 0.6,
        'left_shoulder_roll_joint': 0.2,
        'left_shoulder_pitch_joint': 0.2,
        'right_shoulder_roll_joint': -0.2,
        'right_shoulder_pitch_joint': 0.2,
    },
    joint_vel={'.*': 0.0})

G1_ROBOT_CFG = EntityCfg(
    init_state=KNEES_BENT_KEYFRAME,
    soft_joint_pos_limit_factor=0.9)
