"""Sensor evaluation on a batch of envs (mj_sensorPos/Vel/Acc analog), for
the sensors of the configured scenes: the MuJoCo contact sensor
(mjSENS_CONTACT, intprm = [dataspec, reduce, num]) with the netforce
reduce and the fields that need no contact force (found, dist, pos,
normal, tangent). Counterpart of mjlab_tpu/physics/sensor.py, which also
reads the other sensor types and the force fields; a model that holds
such a sensor raises here. A contact sensor's matching slots are resolved
against the static collision pair table, so at run time it is a masked
reduction over them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from mjref.physics.tables import ix as _ix
from mjref.physics.tables import table
from mjref.physics.types import Data, DisableBit, Model, ModelStatic

CONTACT = 42  # mjtSensor (mujoco 3.10)

OBJ_BODY, OBJ_XBODY, OBJ_JOINT, OBJ_GEOM, OBJ_SITE = 1, 2, 3, 5, 6  # mjtObj

# contact data fields (mjtConDataField), in record order: found, force,
# torque, dist, pos, normal, tangent
_CONDATA_SIZES = (1, 3, 3, 1, 3, 3, 3)
_FORCE_FIELDS = 0b110  # force, torque
REDUCE_NETFORCE = 3


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


def sensors(m: Model, d: Data) -> Data:
  s = m.stat
  if s.nsensor == 0 or (s.disableflags & DisableBit.SENSOR):
    return d
  out = d.sensordata.clone()
  for i in range(s.nsensor):
    st = int(s.sensor_type[i])
    if st != CONTACT:
      raise NotImplementedError(f'sensor type {st} is not copied into mjref')
    _contact_sensor(d, _contact_sensors(s)[i], out)
  return d.replace(sensordata=out)


def _contact_sensor(d: Data, cs: _ContactSensorStatic, out) -> None:
  """Writes one netforce contact sensor's record into `out`
  (B, nsensordata), from the fields its dataspec reads."""
  if cs.reduce != REDUCE_NETFORCE or cs.dataspec & _FORCE_FIELDS:
    raise NotImplementedError(
        f'contact sensor reduce {cs.reduce}, dataspec {cs.dataspec}: mjref '
        'copies the netforce reduce without the force fields')
  if len(cs.slots) == 0:
    return
  dev, dtype = out.device, out.dtype
  B = out.shape[0]
  sl = _ix(cs.slots, dev)
  dist = d.contact.dist[:, sl]
  active = dist < d.contact.includemargin[:, sl]
  poss = d.contact.pos[:, sl]
  found = active.sum(-1)
  z3 = out.new_zeros((B, 3))
  big = torch.full((), 1e10, dtype=dtype, device=dev)
  rec = {
      0: lambda: found.to(dtype),
      3: lambda: torch.where(active, dist, big).amin(-1),
      4: lambda: ((poss * active[..., None]).sum(1)
                  / found.clamp_min(1)[:, None]),
      5: lambda: table(np.array([0.0, 0.0, 1.0]), dtype, dev).expand(B, 3),
      6: lambda: z3}
  off = cs.adr
  for field, size in enumerate(_CONDATA_SIZES):
    if cs.dataspec & (1 << field):
      out[:, off:off + size] = rec[field]().reshape(B, size)
      off += size
