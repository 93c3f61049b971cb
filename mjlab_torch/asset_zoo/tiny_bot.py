"""TinyBot: a minimal 2-DoF debug robot for fast tests and tutorials.

Counterpart of mjlab_tpu/asset_zoo/tiny_bot.py. A free-floating box base
resting on four sphere feet carries a 2-link arm (hinge joints 'shoulder'
and 'elbow') with PD position actuators. It stands under zero action and
runs every manager of the velocity and tracking tasks (a free joint and
scalar joints, PD actuation, floor contacts, foot-friction randomization)
at a fraction of the G1's cost.

This module holds the robot's description tables, its actuator and
collision cfgs, the entity cfg and the action scale, none of which needs
the mujoco package; `get_spec` builds the MjSpec from the tables (it
imports mujoco, which a GPU host may lack). The compiled scene is the one
composed from these cfgs (scene/scene.py) or its committed snapshot.
"""

from __future__ import annotations

from mjlab_torch.asset_zoo.spec_builder import build_robot_spec
from mjlab_torch.entity.entity import EntityCfg, EntityInitStateCfg
from mjlab_torch.entity.spec_config import ActuatorCfg, CollisionCfg

_G = dict(contype=1, conaffinity=1, condim=3, group=3,
          friction=(1.0, 0.005, 0.0001), rgba=(0.6, 0.6, 0.6, 1.0))
_NOCOL = dict(contype=0, conaffinity=0, condim=3, group=2,
              friction=(1.0, 0.005, 0.0001), rgba=(0.8, 0.4, 0.2, 1.0))


def _geom(name, gtype, size, pos, quat=(1.0, 0.0, 0.0, 0.0), **base):
  d = dict(base)
  d.update(name=name, type=gtype, size=size, pos=pos, quat=quat)
  return d


SPEC_DATA = {
    'modelname': 'tiny_bot',
    'bodies': [
        {
            'name': 'base', 'parent': 'world',
            'pos': (0.0, 0.0, 0.0), 'quat': (1.0, 0.0, 0.0, 0.0),
            'mass': 4.0, 'ipos': (0.0, 0.0, 0.0),
            'iquat': (1.0, 0.0, 0.0, 0.0),
            'inertia': (0.02, 0.03, 0.04),
            'joints': [{'name': 'root', 'type': 'free',
                        'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 0.0, 1.0),
                        'range': (0.0, 0.0)}],
            'geoms': [
                _geom('base_collision', 'box', (0.15, 0.1, 0.03),
                      (0.0, 0.0, 0.0), **_G),
            ] + [
                _geom(f'foot{i}_collision', 'sphere', (0.02, 0.0, 0.0),
                      (sx * 0.12, sy * 0.08, -0.05), **_G)
                for i, (sx, sy) in enumerate(
                    [(1, 1), (1, -1), (-1, 1), (-1, -1)])
            ],
            'sites': [{'name': 'imu', 'pos': (0.0, 0.0, 0.03),
                       'quat': (1.0, 0.0, 0.0, 0.0),
                       'size': (0.01, 0.01, 0.01), 'group': 4,
                       'rgba': (1.0, 0.0, 0.0, 1.0)}],
            'cameras': [],
        },
        {
            'name': 'upper_arm', 'parent': 'base',
            'pos': (0.0, 0.0, 0.05), 'quat': (1.0, 0.0, 0.0, 0.0),
            'mass': 0.4, 'ipos': (0.0, 0.0, 0.1),
            'iquat': (1.0, 0.0, 0.0, 0.0),
            'inertia': (0.004, 0.004, 0.0002),
            'joints': [{'name': 'shoulder', 'type': 'hinge',
                        'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 1.0, 0.0),
                        'range': (-1.5, 1.5)}],
            'geoms': [_geom('upper_arm_visual', 'capsule',
                            (0.015, 0.1, 0.0), (0.0, 0.0, 0.1), **_NOCOL)],
            'sites': [], 'cameras': [],
        },
        {
            'name': 'forearm', 'parent': 'upper_arm',
            'pos': (0.0, 0.0, 0.2), 'quat': (1.0, 0.0, 0.0, 0.0),
            'mass': 0.2, 'ipos': (0.0, 0.0, 0.08),
            'iquat': (1.0, 0.0, 0.0, 0.0),
            'inertia': (0.002, 0.002, 0.0001),
            'joints': [{'name': 'elbow', 'type': 'hinge',
                        'pos': (0.0, 0.0, 0.0), 'axis': (0.0, 1.0, 0.0),
                        'range': (-2.0, 2.0)}],
            'geoms': [_geom('forearm_visual', 'capsule',
                            (0.012, 0.08, 0.0), (0.0, 0.0, 0.08), **_NOCOL)],
            'sites': [], 'cameras': [],
        },
    ],
    'excludes': [],
}

TINY_ACTUATOR_CFG = ActuatorCfg(
    joint_names_expr=['shoulder', 'elbow'],
    effort_limit=10.0, stiffness=20.0, damping=1.0, armature=0.001)

# every '.*_collision' geom contype 1, conaffinity 0, condim 3, the feet
# priority 1; every other geom non-colliding
TINY_COLLISION = CollisionCfg(
    geom_names_expr=['.*_collision'],
    contype=1, conaffinity=0, condim={'.*_collision': 3},
    priority={'foot.*_collision': 1})

INIT_STATE = EntityInitStateCfg(
    pos=(0.0, 0.0, 0.075),
    joint_pos={'shoulder': 0.0, 'elbow': 0.0})


def get_spec():
  """The TinyBot's MjSpec from its tables (needs mujoco)."""
  return build_robot_spec(SPEC_DATA)


TINY_ROBOT_CFG = EntityCfg(
    spec_fn=get_spec,
    init_state=INIT_STATE,
    actuators=(TINY_ACTUATOR_CFG,),
    spec_editors=(TINY_COLLISION,),
    soft_joint_pos_limit_factor=0.9)

TINY_ACTION_SCALE = 0.5
