"""Unitree G1 humanoid (29 DoF): the robot's spec, motors, collision
presets, keyframes and entity configuration.

Counterpart of mjlab_tpu/asset_zoo/unitree_g1.py. `get_spec` builds the
real G1 from its data tables (asset_zoo/data/g1_spec_data.py) with the 35
visual meshes of asset_zoo/robots/unitree_g1/assets/ (massless and
non-colliding, so physics is identical with or without them); it needs
the mujoco package, imported when it runs. The motors' actuator cfgs
(rotor inertia reflected through the two-stage planetary gear train, PD
gains at 10 Hz natural frequency and damping ratio 2), the collision
presets, the keyframes, the entity cfg and the per-joint action scale need
no mujoco package. The compiled scenes of the G1 tasks come from the
scene composed from these cfgs (scene/scene.py) or from its committed
snapshot.
"""

from __future__ import annotations

from pathlib import Path

from mjlab_torch.entity.entity import EntityCfg, EntityInitStateCfg
from mjlab_torch.entity.spec_config import ActuatorCfg, CollisionCfg
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


def _cfg(names, act: ElectricActuator, mult: float = 1.0) -> ActuatorCfg:
  kp, kd = act.pd_gains()
  return ActuatorCfg(
      joint_names_expr=names,
      effort_limit=act.effort_limit * mult,
      stiffness=kp * mult, damping=kd * mult,
      armature=act.reflected_inertia * mult)


G1_ACTUATOR_5020 = _cfg(
    ['.*_elbow_joint', '.*_shoulder_pitch_joint', '.*_shoulder_roll_joint',
     '.*_shoulder_yaw_joint', '.*_wrist_roll_joint'], _5020)
G1_ACTUATOR_7520_14 = _cfg(
    ['.*_hip_pitch_joint', '.*_hip_yaw_joint', 'waist_yaw_joint'], _7520_14)
G1_ACTUATOR_7520_22 = _cfg(['.*_hip_roll_joint', '.*_knee_joint'], _7520_22)
G1_ACTUATOR_4010 = _cfg(['.*_wrist_pitch_joint', '.*_wrist_yaw_joint'],
                        _4010)
# waist pitch/roll and ankles are 4-bar linkages driven by two 5020s
# (nominal 1:1, so the pair sums)
G1_ACTUATOR_WAIST = _cfg(['waist_pitch_joint', 'waist_roll_joint'], _5020,
                         mult=2.0)
G1_ACTUATOR_ANKLE = _cfg(['.*_ankle_pitch_joint', '.*_ankle_roll_joint'],
                         _5020, mult=2.0)

G1_ACTUATORS = (
    G1_ACTUATOR_5020, G1_ACTUATOR_7520_14, G1_ACTUATOR_7520_22,
    G1_ACTUATOR_4010, G1_ACTUATOR_WAIST, G1_ACTUATOR_ANKLE)

ASSETS_DIR = Path(__file__).parent / 'robots' / 'unitree_g1' / 'assets'


def get_spec(visuals: bool = True):
  """The real G1's MjSpec; visuals=True attaches the 35 visual meshes
  (massless, non-colliding: physics identical either way). Needs mujoco."""
  from mjlab_torch.asset_zoo.data.g1_spec_data import SPEC_DATA
  from mjlab_torch.asset_zoo.spec_builder import build_robot_spec
  return build_robot_spec(SPEC_DATA, visuals=visuals, assets_dir=ASSETS_DIR)


FOOT_REGEX = r'^(left|right)_foot[1-7]_collision$'

# Collision presets. FULL_COLLISION: everything collides, self-collisions
# included; the non-foot geoms condim 1, the feet condim 3, priority 1 and
# friction 0.6.
FULL_COLLISION = CollisionCfg(
    geom_names_expr=['.*_collision'],
    condim={FOOT_REGEX: 3, '.*_collision': 1},
    priority={FOOT_REGEX: 1},
    friction={FOOT_REGEX: (0.6,)})

FULL_COLLISION_WITHOUT_SELF = CollisionCfg(
    geom_names_expr=['.*_collision'],
    contype=0, conaffinity=1,
    condim={FOOT_REGEX: 3, '.*_collision': 1},
    priority={FOOT_REGEX: 1},
    friction={FOOT_REGEX: (0.6,)})

FEET_ONLY_COLLISION = CollisionCfg(
    geom_names_expr=[FOOT_REGEX],
    contype=0, conaffinity=1, condim=3, priority=1,
    friction=(0.6,))

FULL_COLLISION_WITH_SELF = FULL_COLLISION

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

G1_ROBOT_CFG = EntityCfg(
    spec_fn=get_spec,
    init_state=KNEES_BENT_KEYFRAME,
    actuators=G1_ACTUATORS,
    spec_editors=(FULL_COLLISION,),
    soft_joint_pos_limit_factor=0.9)

# per-joint action scale 0.25 * effort / kp
G1_ACTION_SCALE: 'dict[str, float]' = {
    expr: 0.25 * a.effort_limit / a.stiffness
    for a in G1_ACTUATORS if a.stiffness for expr in a.joint_names_expr}
