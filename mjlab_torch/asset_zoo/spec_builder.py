"""Build an MjSpec from robot description data tables.

The port's own copy of mjlab_tpu/asset_zoo/spec_builder.py: reconstructs a
robot (body tree, explicit inertials, joints, primitive collision geoms,
sites, cameras, contact excludes) from the data modules in
mjlab_torch/asset_zoo/data/. The visual mesh layer (massless, non-colliding)
is not built: it changes no physics.
"""

from __future__ import annotations

import mujoco

_JOINT_TYPE = {
    'free': mujoco.mjtJoint.mjJNT_FREE,
    'ball': mujoco.mjtJoint.mjJNT_BALL,
    'slide': mujoco.mjtJoint.mjJNT_SLIDE,
    'hinge': mujoco.mjtJoint.mjJNT_HINGE,
}
_GEOM_TYPE = {
    'sphere': mujoco.mjtGeom.mjGEOM_SPHERE,
    'capsule': mujoco.mjtGeom.mjGEOM_CAPSULE,
    'cylinder': mujoco.mjtGeom.mjGEOM_CYLINDER,
    'box': mujoco.mjtGeom.mjGEOM_BOX,
    'ellipsoid': mujoco.mjtGeom.mjGEOM_ELLIPSOID,
}
_CAM_MODE = {
    'fixed': mujoco.mjtCamLight.mjCAMLIGHT_FIXED,
    'track': mujoco.mjtCamLight.mjCAMLIGHT_TRACK,
    'trackcom': mujoco.mjtCamLight.mjCAMLIGHT_TRACKCOM,
    'targetbody': mujoco.mjtCamLight.mjCAMLIGHT_TARGETBODY,
    'targetbodycom': mujoco.mjtCamLight.mjCAMLIGHT_TARGETBODYCOM,
}


def build_robot_spec(data: dict) -> mujoco.MjSpec:
  spec = mujoco.MjSpec()
  spec.modelname = data['modelname']
  spec.compiler.degree = False

  parents = {'world': spec.worldbody}
  for bd in data['bodies']:
    body = parents[bd['parent']].add_body(
        name=bd['name'], pos=list(bd['pos']), quat=list(bd['quat']))
    body.mass = bd['mass']
    body.ipos = list(bd['ipos'])
    body.iquat = list(bd['iquat'])
    body.inertia = list(bd['inertia'])
    body.explicitinertial = True
    parents[bd['name']] = body

    for jd in bd['joints']:
      jtype = _JOINT_TYPE[jd['type']]
      kwargs = {}
      if jtype not in (mujoco.mjtJoint.mjJNT_FREE, mujoco.mjtJoint.mjJNT_BALL):
        if jd['range'][0] != 0.0 or jd['range'][1] != 0.0:
          kwargs['range'] = list(jd['range'])
      body.add_joint(name=jd['name'], type=jtype, pos=list(jd['pos']),
                     axis=list(jd['axis']), **kwargs)

    for gd in bd['geoms']:
      body.add_geom(
          name=gd['name'], type=_GEOM_TYPE[gd['type']],
          size=list(gd['size']), pos=list(gd['pos']), quat=list(gd['quat']),
          contype=gd['contype'], conaffinity=gd['conaffinity'],
          condim=gd['condim'], group=gd['group'],
          friction=list(gd['friction']), rgba=list(gd['rgba']))

    for sd in bd['sites']:
      body.add_site(
          name=sd['name'], pos=list(sd['pos']), quat=list(sd['quat']),
          size=list(sd['size']), group=sd['group'], rgba=list(sd['rgba']))

    for cd in bd['cameras']:
      body.add_camera(name=cd['name'], pos=list(cd['pos']),
                      quat=list(cd['quat']), mode=_CAM_MODE[cd['mode']],
                      fovy=cd['fovy'])

  for b1, b2 in data['excludes']:
    exc = spec.add_exclude()
    exc.bodyname1 = b1
    exc.bodyname2 = b2
  return spec
