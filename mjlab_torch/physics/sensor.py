"""Sensor evaluation on a batch of envs (mj_sensorPos/Vel/Acc analog).

Counterpart of mjlab_tpu/physics/sensor.py, every sensor type it takes:
jointpos and jointvel; actuatorpos, actuatorvel and actuatorfrc; gyro,
velocimeter and accelerometer; framepos and framequat (with a reference
frame), frame x, y and z axes, framelinvel and frameangvel; subtreecom and
subtreelinvel; touch; and the MuJoCo contact sensor (mjSENS_CONTACT,
intprm = [dataspec, reduce, num]) in every data field and reduce mode.
A contact sensor's matching slots are resolved against the static
collision pair table, so at run time it is a masked reduction over them;
`contact_force` decodes each slot's contact-frame force from efc_force.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mjlab_torch.physics import math as pmath
from mjlab_torch.physics.constraint import (
    compaction_slot_pools,
    deepest,
    efc_layout,
    elliptic_dmax,
    elliptic_row_maps,
)
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.tables import table
from mjlab_torch.physics.types import Data, DisableBit, Model, ModelStatic

# mjtSensor values (mujoco 3.10)
TOUCH = 0
ACCELEROMETER = 1
VELOCIMETER = 2
GYRO = 3
JOINTPOS = 9
JOINTVEL = 10
ACTUATORPOS = 13
ACTUATORVEL = 14
ACTUATORFRC = 15
FRAMEPOS = 26
FRAMEQUAT = 27
FRAMEXAXIS = 28
FRAMEYAXIS = 29
FRAMEZAXIS = 30
FRAMELINVEL = 31
FRAMEANGVEL = 32
SUBTREECOM = 35
SUBTREELINVEL = 36
CONTACT = 42

OBJ_BODY, OBJ_XBODY, OBJ_JOINT, OBJ_GEOM, OBJ_SITE = 1, 2, 3, 5, 6  # mjtObj

# contact data fields (mjtConDataField), in record order: found, force,
# torque, dist, pos, normal, tangent
_CONDATA_SIZES = (1, 3, 3, 1, 3, 3, 3)
REDUCE_NONE, REDUCE_MINDIST, REDUCE_MAXFORCE, REDUCE_NETFORCE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class _ContactSensorStatic:
  slots: np.ndarray  # matching contact slot ids
  flip: np.ndarray  # 1.0 where the sensor's primary object is geom2
  dataspec: int
  reduce: int
  num: int
  adr: int


def _geom_set(stat: ModelStatic, objtype: int, objid: int) -> set:
  if objtype == OBJ_GEOM:
    return {objid}
  if objtype == OBJ_BODY:
    return set(np.nonzero(stat.geom_bodyid == objid)[0])
  if objtype == OBJ_XBODY:  # subtree
    bodies = set()
    for b in range(stat.nbody):
      cur = b
      while True:
        if cur == objid:
          bodies.add(b)
          break
        if cur == 0:
          break
        cur = stat.body_parentid[cur]
    return set(np.nonzero(np.isin(stat.geom_bodyid, list(bodies)))[0])
  raise NotImplementedError(f'contact sensor objtype {objtype}')


@functools.lru_cache(maxsize=32)
def _contact_sensors(stat: ModelStatic) -> dict:
  out = {}
  g1s = np.asarray(stat.con_geom1[:stat.pairs.ncon_max])
  g2s = np.asarray(stat.con_geom2[:stat.pairs.ncon_max])
  for i in range(stat.nsensor):
    if stat.sensor_type[i] != CONTACT:
      continue
    set1 = _geom_set(stat, int(stat.sensor_objtype[i]),
                     int(stat.sensor_objid[i]))
    if stat.sensor_refid[i] >= 0 or (stat.sensor_reftype[i] == OBJ_GEOM
                                     and stat.sensor_refid[i] == 0):
      set2 = _geom_set(stat, int(stat.sensor_reftype[i]),
                       int(stat.sensor_refid[i]))
    else:
      set2 = None
    slots, flip = [], []
    for c, (g1, g2) in enumerate(zip(g1s, g2s)):
      g1, g2 = int(g1), int(g2)
      if set2 is None:
        hit1, hit2 = g1 in set1, g2 in set1
      else:
        hit1 = g1 in set1 and g2 in set2
        hit2 = g2 in set1 and g1 in set2
      if hit1 or hit2:
        slots.append(c)
        flip.append(0.0 if hit1 else 1.0)
    dataspec, reduce, num = (int(v) for v in stat.sensor_intprm[i][:3])
    out[i] = _ContactSensorStatic(
        slots=np.asarray(slots, np.int32), flip=np.asarray(flip),
        dataspec=dataspec, reduce=reduce, num=num,
        adr=int(stat.sensor_adr[i]))
  return out


def _scatter_rows(force, idx, rows):
  """force (B, ncon, 6) with the rows (B, K, k <= 6) written at the slots
  idx (B, K) (distinct in each env), columns beyond k left as they are."""
  k = rows.shape[-1]
  full = torch.cat([rows, force.new_zeros(rows.shape[:-1] + (6 - k,))], -1)
  return force.scatter(1, idx[..., None].expand(full.shape), full)


def contact_force(m: Model, d: Data) -> torch.Tensor:
  """Per contact slot, its force in the contact frame (B, ncon, 6),
  decoded from efc_force (mj_contactForce): a pyramid's rows give the
  normal force as their sum and each friction axis as mu (f+ - f-); an
  elliptic slot's rows are its contact-frame components. Compacted: the
  rows belong to each pool's deepest slots, chosen again as make_efc
  chose them. The torque part is zero for condim <= 3."""
  s = m.stat
  dev, dtype = d.qpos.device, d.qpos.dtype
  B = d.qpos.shape[0]
  lay = efc_layout(s)
  ncon = max(s.pairs.ncon_max, 1)
  force = torch.zeros((B, ncon, 6), dtype=dtype, device=dev)
  if not s.pairs.ncon_max:
    return force
  f = d.efc_force
  compacted = bool(s.ncon_cap or s.ncon_cap1)
  slots3, slots1 = compaction_slot_pools(s)
  p_all = d.contact.dist - d.contact.includemargin
  K3, K1 = s.ncon_cap, s.ncon_cap1

  def chosen(slots, K):  # (B, K) slot ids of a pool's deepest K
    sl = _ix(slots, dev)
    return sl[deepest(p_all[:, sl], K)]

  dm = elliptic_dmax(s)
  if dm:  # the elliptic rows are the contact-frame components
    x_rows, c1_rows = elliptic_row_maps(s)
    f_pad = torch.cat([f, f.new_zeros((B, 1))], dim=1)
    rows3 = f_pad[:, _ix(x_rows, dev)]  # (NX, DM); axes past condim: 0
    rows1 = f_pad[:, _ix(c1_rows, dev)]
    if compacted:
      if K3:
        force = _scatter_rows(force, chosen(slots3, K3), rows3)
      if K1:
        force = _scatter_rows(force, chosen(slots1, K1), rows1[..., None])
      return force
    if len(slots3):
      force[:, _ix(slots3, dev), :dm] = rows3
    if len(slots1):
      force[:, _ix(slots1, dev), 0] = rows1
    return force

  if compacted:
    A = max(int(s.con_dim.max()) - 1, 1)
    if K3:
      idx = chosen(slots3, K3)
      rows = f[:, _ix(lay.con_base[:K3, None] + np.arange(2 * A)[None, :],
                      dev)]
      pairs = rows.reshape(B, K3, A, 2)
      dim = table(s.con_dim, torch.int32, dev)[idx]
      real_axis = torch.arange(A, device=dev) < (dim[..., None] - 1)
      fr = torch.gather(d.contact.friction, 1,
                        idx[..., None].expand(B, K3, 5))[..., :A]
      mu = torch.where(real_axis, fr, fr.new_zeros(()))
      force = _scatter_rows(force, idx, torch.cat(
          [pairs.sum((2, 3))[..., None],
           mu * (pairs[..., 0] - pairs[..., 1])], -1))
    if K1:
      force = _scatter_rows(force, chosen(slots1, K1),
                            f[:, _ix(lay.con_base[K3:K3 + K1], dev), None])
    return force

  nc = s.pairs.ncon_max
  for dim in sorted(set(int(x) for x in s.con_dim[:nc])):
    sl_np = np.nonzero(s.con_dim[:nc] == dim)[0]
    sl = _ix(sl_np, dev)
    if dim == 1:
      force[:, sl, 0] = f[:, _ix(lay.con_base[sl_np], dev)]
      continue
    k = 2 * (dim - 1)
    rows = f[:, _ix(lay.con_base[sl_np][:, None] + np.arange(k)[None, :],
                    dev)]  # (B, nsl, k)
    pairs = rows.reshape(B, len(sl_np), dim - 1, 2)
    mu = d.contact.friction[:, sl, :dim - 1]
    force[:, sl, 0] = rows.sum(-1)
    force[:, sl, 1:dim] = mu * (pairs[..., 0] - pairs[..., 1])
  return force


def _object_pos_mat(d: Data, objtype: int, objid: int):
  if objtype == OBJ_SITE:
    return d.site_xpos[:, objid], d.site_xmat[:, objid]
  if objtype == OBJ_BODY:
    return d.xipos[:, objid], d.ximat[:, objid]
  if objtype == OBJ_XBODY:
    return d.xpos[:, objid], d.xmat[:, objid]
  if objtype == OBJ_GEOM:
    return d.geom_xpos[:, objid], d.geom_xmat[:, objid]
  raise NotImplementedError(f'frame sensor objtype {objtype}')


def _object_body(stat: ModelStatic, objtype: int, objid: int) -> int:
  if objtype == OBJ_SITE:
    return int(stat.site_bodyid[objid])
  if objtype in (OBJ_BODY, OBJ_XBODY):
    return int(objid)
  if objtype == OBJ_GEOM:
    return int(stat.geom_bodyid[objid])
  raise NotImplementedError(f'sensor objtype {objtype}')


def _point_vel(m: Model, d: Data, body: int, pos: torch.Tensor):
  """(angular, linear) world velocity (B, 3) each of a point on body."""
  v = d.cvel[:, body]
  ang = v[..., :3]
  croot = d.subtree_com[:, int(m.stat.body_rootid[body])]
  return ang, v[..., 3:] + pmath.cross(ang, pos - croot)


def _local(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
  """mat^T v for mat (B, 3, 3), v (B, 3)."""
  return torch.einsum('bji,bj->bi', mat, v)


def _cacc(m: Model, d: Data) -> torch.Tensor:
  """Post-solve body spatial accelerations (B, nbody, 6), the subset of
  mj_rnePostConstraint the accelerometer reads."""
  s = m.stat
  anc = table(s.ancestor_mask, d.qpos.dtype, d.qpos.device)
  a0 = torch.cat([torch.zeros_like(m.opt.gravity), -m.opt.gravity])
  if s.disableflags & DisableBit.GRAVITY:
    a0 = torch.zeros_like(a0)
  return a0 + anc @ (d.cdof_dot * d.qvel[..., None]
                     + d.cdof * d.qacc[..., None])


def sensors(m: Model, d: Data) -> Data:
  s = m.stat
  if s.nsensor == 0 or (s.disableflags & DisableBit.SENSOR):
    return d
  dev, dtype = d.qpos.device, d.qpos.dtype
  out = d.sensordata.clone()
  cacc = None

  @functools.cache
  def get_cforce():
    return contact_force(m, d)

  for i in range(s.nsensor):
    st = int(s.sensor_type[i])
    adr = int(s.sensor_adr[i])
    objtype, objid = int(s.sensor_objtype[i]), int(s.sensor_objid[i])
    reftype, refid = int(s.sensor_reftype[i]), int(s.sensor_refid[i])

    if st == JOINTPOS:
      out[:, adr] = d.qpos[:, int(s.jnt_qposadr[objid])]
    elif st == JOINTVEL:
      out[:, adr] = d.qvel[:, int(s.jnt_dofadr[objid])]
    elif st == ACTUATORPOS:
      out[:, adr] = d.actuator_length[:, objid]
    elif st == ACTUATORVEL:
      out[:, adr] = d.actuator_velocity[:, objid]
    elif st == ACTUATORFRC:
      out[:, adr] = d.actuator_force[:, objid]
    elif st == GYRO:
      body = _object_body(s, objtype, objid)
      out[:, adr:adr + 3] = _local(d.site_xmat[:, objid],
                                   d.cvel[:, body, :3])
    elif st == VELOCIMETER:
      body = _object_body(s, objtype, objid)
      _, lin = _point_vel(m, d, body, d.site_xpos[:, objid])
      out[:, adr:adr + 3] = _local(d.site_xmat[:, objid], lin)
    elif st == ACCELEROMETER:
      if cacc is None:
        cacc = _cacc(m, d)
      body = _object_body(s, objtype, objid)
      p = d.site_xpos[:, objid]
      offset = p - d.subtree_com[:, int(s.body_rootid[body])]
      acc = pmath.transform_motion(cacc[:, body], offset)
      ang, lin = _point_vel(m, d, body, p)
      out[:, adr:adr + 3] = _local(d.site_xmat[:, objid],
                                   acc[..., 3:] + pmath.cross(ang, lin))
    elif st == FRAMEPOS:
      pos, _ = _object_pos_mat(d, objtype, objid)
      if refid >= 0:
        rpos, rmat = _object_pos_mat(d, reftype, refid)
        pos = _local(rmat, pos - rpos)
      out[:, adr:adr + 3] = pos
    elif st == FRAMEQUAT:
      _, mat = _object_pos_mat(d, objtype, objid)
      q = pmath.mat_to_quat(mat)
      if refid >= 0:
        _, rmat = _object_pos_mat(d, reftype, refid)
        q = pmath.mul_quat(pmath.neg_quat(pmath.mat_to_quat(rmat)), q)
      out[:, adr:adr + 4] = q
    elif st in (FRAMEXAXIS, FRAMEYAXIS, FRAMEZAXIS):
      _, mat = _object_pos_mat(d, objtype, objid)
      out[:, adr:adr + 3] = mat[..., st - FRAMEXAXIS]
    elif st == FRAMELINVEL:
      body = _object_body(s, objtype, objid)
      pos, _ = _object_pos_mat(d, objtype, objid)
      out[:, adr:adr + 3] = _point_vel(m, d, body, pos)[1]
    elif st == FRAMEANGVEL:
      out[:, adr:adr + 3] = d.cvel[:, _object_body(s, objtype, objid), :3]
    elif st == SUBTREECOM:
      out[:, adr:adr + 3] = d.subtree_com[:, objid]
    elif st == SUBTREELINVEL:
      # the subtree's linear momentum over its mass
      wmass = table(s.subtree_mask[objid], dtype, dev) * m.body_mass
      root = _ix(s.body_rootid, dev)
      lin = d.cvel[..., 3:] + pmath.cross(d.cvel[..., :3],
                                          d.xipos - d.subtree_com[:, root])
      mom = (wmass[..., None] * lin).sum(-2)
      out[:, adr:adr + 3] = mom / wmass.sum(-1).clamp_min(1e-12)[..., None]
    elif st == TOUCH:
      # normal forces of the active contacts of the site's body's geoms
      cforce = get_cforce()
      body = int(s.site_bodyid[objid])
      match = table((s.geom_bodyid[s.con_geom1] == body)
                    | (s.geom_bodyid[s.con_geom2] == body), torch.bool, dev)
      active = d.contact.dist < d.contact.includemargin
      out[:, adr] = torch.where(match & active, cforce[..., 0],
                                cforce.new_zeros(())).sum(-1)
    elif st == CONTACT:
      _contact_sensor(d, _contact_sensors(s)[i], get_cforce, out)
    else:
      raise NotImplementedError(f'sensor type {st} is not supported')
  return d.replace(sensordata=out)


def _contact_sensor(d: Data, cs: _ContactSensorStatic, cforce, out) -> None:
  """Writes one contact sensor's records into `out` (B, nsensordata).
  `cforce()` gives contact_force; it is called, and each field computed,
  only when the sensor's data or reduce mode reads it."""
  if len(cs.slots) == 0:
    return
  dev, dtype = out.device, out.dtype
  B, k = out.shape[0], len(cs.slots)
  sl = _ix(cs.slots, dev)
  dist = d.contact.dist[:, sl]
  active = dist < d.contact.includemargin[:, sl]
  frames = d.contact.frame[:, sl]  # (B, k, 3, 3) rows normal, t1, t2
  sign = table(1.0 - 2.0 * cs.flip, dtype, dev)
  poss = d.contact.pos[:, sl]
  found = active.sum(-1)
  z3 = out.new_zeros((B, 3))

  @functools.cache
  def f_world():  # the force on the secondary set, turned onto the primary
    f = torch.einsum('bkfx,bkf->bkx', frames, cforce()[:, sl, :3])
    return f * sign[:, None] * active[..., None].to(dtype)

  normals = lambda: frames[:, :, 0] * sign[:, None]

  def write(base, rec):
    off = base
    for field, size in enumerate(_CONDATA_SIZES):
      if cs.dataspec & (1 << field):
        out[:, off:off + size] = rec[field]().reshape(B, size)
        off += size

  big = torch.full((), 1e10, dtype=dtype, device=dev)
  count = lambda: found.to(dtype)
  if cs.reduce == REDUCE_NETFORCE:
    write(cs.adr, {
        0: count, 1: lambda: f_world().sum(1), 2: lambda: z3,
        3: lambda: torch.where(active, dist, big).amin(-1),
        4: lambda: ((poss * active[..., None]).sum(1)
                    / found.clamp_min(1)[:, None]),
        5: lambda: table(np.array([0.0, 0.0, 1.0]), dtype, dev).expand(B, 3),
        6: lambda: z3})
    return

  take = lambda x, idx: torch.gather(  # x (B, k, ...) at idx (B,)
      x, 1, idx.reshape((B, 1) + (1,) * (x.dim() - 2)).expand(
          (B, 1) + x.shape[2:]))[:, 0]
  if cs.reduce in (REDUCE_MINDIST, REDUCE_MAXFORCE):
    if cs.reduce == REDUCE_MINDIST:
      idx = torch.argmin(torch.where(active, dist, big), dim=-1)
    else:
      mag = torch.linalg.vector_norm(f_world(), dim=-1)
      idx = torch.argmax(torch.where(active, mag, -torch.ones_like(mag)),
                         dim=-1)
    write(cs.adr, {0: count, 1: lambda: take(f_world(), idx),
                   2: lambda: z3, 3: lambda: take(dist, idx),
                   4: lambda: take(poss, idx),
                   5: lambda: take(normals(), idx),
                   6: lambda: take(frames[:, :, 1], idx)})
    return

  # reduce none: the first `num` active contacts in slot order
  ar = torch.arange(k, device=dev)
  order = torch.argsort(torch.where(active, ar, k + ar), dim=-1)
  rec_size = sum(n for f, n in enumerate(_CONDATA_SIZES)
                 if cs.dataspec & (1 << f))
  zero = out.new_zeros(())
  for j in range(min(cs.num, k)):
    sel = order[:, j]
    ok = lambda: (take(active, sel) & (j < found))[:, None]
    write(cs.adr + j * rec_size, {
        0: count,
        1: lambda: torch.where(ok(), take(f_world(), sel), z3),
        2: lambda: z3,
        3: lambda: torch.where(ok()[:, 0], take(dist, sel), zero),
        4: lambda: torch.where(ok(), take(poss, sel), z3),
        5: lambda: torch.where(ok(), take(normals(), sel), z3),
        6: lambda: torch.where(ok(), take(frames[:, :, 1], sel), z3)})
