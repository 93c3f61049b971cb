"""Build an MjSpec from robot description data tables.

The port's own copy of mjlab_tpu/asset_zoo/spec_builder.py: reconstructs a
robot (body tree, explicit inertials, joints, primitive collision geoms,
sites, cameras, contact excludes) from the data modules in
mjlab_torch/asset_zoo/data/. The visual mesh layer (massless, non-colliding
group-2 mesh geoms over the robot's meshes in asset_zoo/robots/) is
attached when visuals=True; physics is the same either way.
"""

from __future__ import annotations

from pathlib import Path

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


def build_robot_spec(data: dict, visuals: bool = True,
                     assets_dir=None) -> mujoco.MjSpec:
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

  vis = data.get('visuals')
  if vis and visuals and assets_dir is not None:
    _add_visuals(spec, parents, vis, Path(assets_dir))
  return spec


def _mesh_reader(assets_dir: Path):
  """file name -> (verts, faces): from the directory's mesh pack where it
  has one (the shipped robots), else from the STL file itself."""
  from mjlab_torch.asset_zoo.stl import MESH_PACK, load_pack, load_stl
  pack = assets_dir / MESH_PACK
  if pack.exists():
    return load_pack(str(pack)).__getitem__
  return lambda name: load_stl(str(assets_dir / name))


def _add_visuals(spec: mujoco.MjSpec, bodies: dict, vis: dict,
                 assets_dir: Path) -> None:
  """Attach the visual mesh layer: the meshes embedded as uservert and
  userface (so MjSpec.attach during scene composition never resolves a
  mesh directory) and massless contype = conaffinity = 0 group-2 mesh
  geoms, as mjlab_tpu/asset_zoo/spec_builder.py attaches them."""
  read = _mesh_reader(assets_dir)
  for md in vis['meshes']:
    verts, faces = read(md['file'])
    mesh = spec.add_mesh()
    mesh.name = md['name']
    mesh.uservert = verts.ravel().tolist()
    mesh.userface = faces.ravel().tolist()
  for i, gd in enumerate(vis['geoms']):
    g = bodies[gd['body']].add_geom(
        name=f"{gd['mesh']}_visual_{i}",
        type=mujoco.mjtGeom.mjGEOM_MESH, meshname=gd['mesh'],
        pos=list(gd['pos']), quat=list(gd['quat']),
        contype=0, conaffinity=0, group=2, rgba=list(gd['rgba']))
    g.density = 0.0
