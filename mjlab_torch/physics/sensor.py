"""Sensor evaluation on a batch of envs.

Counterpart of mjlab_tpu/physics/sensor.py for the MuJoCo contact sensor
(mjSENS_CONTACT, intprm = [dataspec, reduce, num]) in its found-only form,
the form the velocity tasks' foot-contact sensors request. Matching slots
are resolved against the static collision pair table, so at run time each
sensor is a masked count over its slots. Other sensor types and other
contact data fields raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.types import Data, DisableBit, Model, ModelStatic

CONTACT = 42  # mjtSensor
OBJ_BODY, OBJ_XBODY, OBJ_GEOM = 1, 2, 5  # mjtObj
FOUND_ONLY = 1  # dataspec bit of the 'found' field
REDUCE_NONE = 0


@dataclasses.dataclass(frozen=True)
class _ContactSensorStatic:
  slots: np.ndarray  # matching contact slot ids
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
    slots = []
    for c, (g1, g2) in enumerate(zip(g1s, g2s)):
      g1, g2 = int(g1), int(g2)
      if set2 is None:
        hit = g1 in set1 or g2 in set1
      else:
        hit = (g1 in set1 and g2 in set2) or (g2 in set1 and g1 in set2)
      if hit:
        slots.append(c)
    dataspec, reduce, num = (int(v) for v in stat.sensor_intprm[i][:3])
    out[i] = _ContactSensorStatic(
        slots=np.asarray(slots, np.int32), dataspec=dataspec, reduce=reduce,
        num=num, adr=int(stat.sensor_adr[i]))
  return out


def sensors(m: Model, d: Data) -> Data:
  s = m.stat
  if s.nsensor == 0 or (s.disableflags & DisableBit.SENSOR):
    return d
  out = d.sensordata.clone()
  contact = _contact_sensors(s)
  for i in range(s.nsensor):
    if int(s.sensor_type[i]) != CONTACT:
      raise NotImplementedError(
          f'sensor type {int(s.sensor_type[i])} is not implemented in '
          'mjlab_torch yet')
    cs = contact[i]
    if cs.dataspec != FOUND_ONLY:
      raise NotImplementedError(
          f'contact sensor dataspec {cs.dataspec}: only the found-only '
          'form is implemented in mjlab_torch yet')
    if len(cs.slots) == 0:
      continue
    sl = _ix(cs.slots, d.qpos.device)
    active = d.contact.dist[:, sl] < d.contact.includemargin[:, sl]
    found = active.sum(-1).to(out.dtype)
    # reduce == none writes one record (here: the count) per contact
    nrec = min(cs.num, len(cs.slots)) if cs.reduce == REDUCE_NONE else 1
    out[:, cs.adr:cs.adr + nrec] = found[:, None]
  return d.replace(sensordata=out)
