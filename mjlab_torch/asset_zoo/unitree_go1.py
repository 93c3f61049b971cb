"""Unitree Go1 quadruped (12 DoF): the robot's spec, motors, collision
presets, keyframe and entity configuration.

Counterpart of mjlab_tpu/asset_zoo/unitree_go1.py. `get_spec` builds the
real Go1 from its data tables (asset_zoo/data/go1_spec_data.py) with the
visual meshes of asset_zoo/robots/unitree_go1/assets/ (massless and
non-colliding; the trunk has none, as in the JAX package); it needs the
mujoco package, imported when it runs. The hip and knee motors
(GO-M8010-6: rotor inertia reflected through gears 6 and 9, PD gains at
10 Hz and damping ratio 2) as actuator cfgs, the collision presets, the
standing keyframe, the foot regex, the entity cfg and the per-joint action
scale need no mujoco package.
"""

from __future__ import annotations

from pathlib import Path

from mjlab_torch.entity.entity import EntityCfg, EntityInitStateCfg
from mjlab_torch.entity.spec_config import ActuatorCfg, CollisionCfg
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

_KP_HIP, _KD_HIP = HIP_ACTUATOR.pd_gains()
_KP_KNEE, _KD_KNEE = KNEE_ACTUATOR.pd_gains()

GO1_HIP_ACTUATOR_CFG = ActuatorCfg(
    joint_names_expr=['.*_hip_joint', '.*_thigh_joint'],
    effort_limit=HIP_ACTUATOR.effort_limit,
    stiffness=_KP_HIP, damping=_KD_HIP,
    armature=HIP_ACTUATOR.reflected_inertia)
GO1_KNEE_ACTUATOR_CFG = ActuatorCfg(
    joint_names_expr=['.*_calf_joint'],
    effort_limit=KNEE_ACTUATOR.effort_limit,
    stiffness=_KP_KNEE, damping=_KD_KNEE,
    armature=KNEE_ACTUATOR.reflected_inertia)
GO1_ACTUATORS = (GO1_HIP_ACTUATOR_CFG, GO1_KNEE_ACTUATOR_CFG)

ASSETS_DIR = Path(__file__).parent / 'robots' / 'unitree_go1' / 'assets'


def get_spec(visuals: bool = True):
  """The real Go1's MjSpec; visuals=True attaches the visual meshes
  (massless, non-colliding: physics identical either way). Needs mujoco."""
  from mjlab_torch.asset_zoo.data.go1_spec_data import SPEC_DATA
  from mjlab_torch.asset_zoo.spec_builder import build_robot_spec
  return build_robot_spec(SPEC_DATA, visuals=visuals, assets_dir=ASSETS_DIR)


FOOT_REGEX = '^[FR][LR]_foot_collision$'

# Collision presets
FEET_ONLY_COLLISION = CollisionCfg(
    geom_names_expr=[FOOT_REGEX],
    contype=0, conaffinity=1, condim=3, priority=1,
    friction=(0.6,), solimp=(0.9, 0.95, 0.023))

# every collision geom collides with the world and not with the robot
# itself; the feet condim 3, priority 1, friction 0.6 and solimp (0.9,
# 0.95, 0.023), the rest condim 1
FULL_COLLISION = CollisionCfg(
    geom_names_expr=['.*_collision'],
    condim={FOOT_REGEX: 3, '.*_collision': 1},
    priority={FOOT_REGEX: 1},
    friction={FOOT_REGEX: (0.6,)},
    solimp={FOOT_REGEX: (0.9, 0.95, 0.023)},
    contype=1, conaffinity=0)

INIT_STATE = EntityInitStateCfg(
    pos=(0.0, 0.0, 0.278),
    joint_pos={
        '.*thigh_joint': 0.9,
        '.*calf_joint': -1.8,
        '.*R_hip_joint': 0.1,
        '.*L_hip_joint': -0.1,
    },
    joint_vel={'.*': 0.0})

GO1_ROBOT_CFG = EntityCfg(
    spec_fn=get_spec,
    init_state=INIT_STATE,
    actuators=GO1_ACTUATORS,
    spec_editors=(FULL_COLLISION,),
    soft_joint_pos_limit_factor=0.9)

# per-joint action scale 0.25 * effort / kp
GO1_ACTION_SCALE: 'dict[str, float]' = {
    expr: 0.25 * a.effort_limit / a.stiffness
    for a in GO1_ACTUATORS if a.stiffness for expr in a.joint_names_expr}
