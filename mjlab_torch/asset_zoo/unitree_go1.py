"""Unitree Go1 quadruped (12 DoF): motors, keyframe and entity configuration.

Counterpart of the constants of mjlab_tpu/asset_zoo/unitree_go1.py that need
no mujoco package: the hip and knee motor classes (GO-M8010-6: rotor
inertia reflected through gears 6 and 9, PD gains at 10 Hz and damping
ratio 2), the standing keyframe, the foot regex, the entity cfg and the
per-joint action scale. The compiled model itself comes from
asset_zoo/go1_flat_scene.py (which needs mujoco) or from its committed
snapshot.
"""

from __future__ import annotations

from mjlab_torch.entity.entity import EntityCfg, EntityInitStateCfg
from mjlab_torch.utils.actuator import ElectricActuator, reflected_inertia

ROTOR_INERTIA = 0.000111842
HIP_GEAR_RATIO = 6.0
KNEE_GEAR_RATIO = HIP_GEAR_RATIO * 1.5

HIP_ACTUATOR = ElectricActuator(
    reflected_inertia=reflected_inertia(ROTOR_INERTIA, HIP_GEAR_RATIO),
    velocity_limit=30.1, effort_limit=23.7)
KNEE_ACTUATOR = ElectricActuator(
    reflected_inertia=reflected_inertia(ROTOR_INERTIA, KNEE_GEAR_RATIO),
    velocity_limit=20.06, effort_limit=35.55)

# (joint regexes, motor, multiplier), as asset_zoo/unitree_g1.py has them
GO1_ACTUATORS = (
    (['.*_hip_joint', '.*_thigh_joint'], HIP_ACTUATOR, 1.0),
    (['.*_calf_joint'], KNEE_ACTUATOR, 1.0),
)

FOOT_REGEX = '^[FR][LR]_foot_collision$'

INIT_STATE = EntityInitStateCfg(
    pos=(0.0, 0.0, 0.278),
    joint_pos={
        '.*thigh_joint': 0.9,
        '.*calf_joint': -1.8,
        '.*R_hip_joint': 0.1,
        '.*L_hip_joint': -0.1,
    },
    joint_vel={'.*': 0.0})

GO1_ROBOT_CFG = EntityCfg(init_state=INIT_STATE,
                          soft_joint_pos_limit_factor=0.9)

# per-joint action scale 0.25 * effort / kp
GO1_ACTION_SCALE: 'dict[str, float]' = {
    expr: 0.25 * act.effort_limit / act.pd_gains()[0]
    for exprs, act, _ in GO1_ACTUATORS for expr in exprs}
