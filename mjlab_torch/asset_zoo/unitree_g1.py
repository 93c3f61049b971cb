"""Unitree G1 humanoid (29 DoF): motors, keyframes and entity configuration.

Counterpart of the constants of mjlab_tpu/asset_zoo/unitree_g1.py that need
no mujoco package: the motor classes with their reflected inertias and PD
gains, the home and knees-bent keyframes, the entity cfg and the per-joint
action scale. The compiled model itself comes from asset_zoo/g1_flat_scene.py
(which needs mujoco) or from its committed snapshot.
"""

from __future__ import annotations

from mjlab_torch.entity.entity import EntityCfg, EntityInitStateCfg
from mjlab_torch.utils.actuator import (
    ElectricActuator,
    reflected_inertia_two_stage_planetary,
)

_ARMATURE_5020 = reflected_inertia_two_stage_planetary(
    (0.139e-4, 0.017e-4, 0.169e-4), (1, 1 + 46 / 18, 1 + 56 / 16))
_ARMATURE_7520_14 = reflected_inertia_two_stage_planetary(
    (0.489e-4, 0.098e-4, 0.533e-4), (1, 4.5, 1 + 48 / 22))
_ARMATURE_7520_22 = reflected_inertia_two_stage_planetary(
    (0.489e-4, 0.109e-4, 0.738e-4), (1, 4.5, 5))
_ARMATURE_4010 = reflected_inertia_two_stage_planetary(
    (0.068e-4, 0.0, 0.0), (1, 5, 5))

_5020 = ElectricActuator(_ARMATURE_5020, 37.0, 25.0)
_7520_14 = ElectricActuator(_ARMATURE_7520_14, 32.0, 88.0)
_7520_22 = ElectricActuator(_ARMATURE_7520_22, 20.0, 139.0)
_4010 = ElectricActuator(_ARMATURE_4010, 22.0, 5.0)

# (joint regexes, motor, multiplier); waist pitch/roll and ankles are
# 4-bar linkages driven by two 5020s (nominal 1:1, so the pair sums)
G1_ACTUATORS = (
    (['.*_elbow_joint', '.*_shoulder_pitch_joint', '.*_shoulder_roll_joint',
      '.*_shoulder_yaw_joint', '.*_wrist_roll_joint'], _5020, 1.0),
    (['.*_hip_pitch_joint', '.*_hip_yaw_joint', 'waist_yaw_joint'],
     _7520_14, 1.0),
    (['.*_hip_roll_joint', '.*_knee_joint'], _7520_22, 1.0),
    (['.*_wrist_pitch_joint', '.*_wrist_yaw_joint'], _4010, 1.0),
    (['waist_pitch_joint', 'waist_roll_joint'], _5020, 2.0),
    (['.*_ankle_pitch_joint', '.*_ankle_roll_joint'], _5020, 2.0),
)

FOOT_REGEX = r'^(left|right)_foot[1-7]_collision$'

# the home pose the synthetic motions of scripts/motion.py start from
HOME_KEYFRAME = EntityInitStateCfg(
    pos=(0.0, 0.0, 0.783675),
    joint_pos={
        '.*_hip_pitch_joint': -0.1,
        '.*_knee_joint': 0.3,
        '.*_ankle_pitch_joint': -0.2,
        '.*_shoulder_pitch_joint': 0.2,
        '.*_elbow_joint': 1.28,
        'left_shoulder_roll_joint': 0.2,
        'right_shoulder_roll_joint': -0.2,
    },
    joint_vel={'.*': 0.0})

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

G1_ROBOT_CFG = EntityCfg(init_state=KNEES_BENT_KEYFRAME,
                         soft_joint_pos_limit_factor=0.9)

# per-joint action scale 0.25 * effort / kp; the multiplier of a summed
# pair cancels
G1_ACTION_SCALE: 'dict[str, float]' = {
    expr: 0.25 * act.effort_limit / act.pd_gains()[0]
    for exprs, act, _ in G1_ACTUATORS for expr in exprs}
