"""MjModel -> torch Model conversion and batched Data allocation.

Counterpart of mjlab_tpu/physics/io.py. CPU MuJoCo stays the build-time
compiler; this module turns a compiled `mujoco.MjModel` into the engine's
`Model` (tensors on one device) and allocates a batched `Data`.

`ModelArrays` is a snapshot of the compiled model's fields the engine
reads, saved to and loaded from an .npz file: `put_model` takes it in place
of an MjModel, so a host without the mujoco package (a GPU machine) can
build the engine's Model from a model compiled elsewhere.

`model_from_numpy` / `data_from_numpy` carry state across from any other
holder of the same leaves (for example the JAX package's `Model` / `Data`
converted to numpy), so two engines can be fed identical inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mjlab_torch.physics import mesh as _mesh
from mjlab_torch.physics.constraint import efc_layout
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.types import (
    CollisionPairs,
    Contact,
    Data,
    GeomType,
    JointType,
    Model,
    ModelStatic,
    Option,
)

_ENBL_OVERRIDE = 1  # mjtEnableBit.mjENBL_OVERRIDE
_TRN_JOINT = 0  # mjtTrn.mjTRN_JOINT
_DYN_NONE, _DYN_INTEGRATOR, _DYN_FILTER, _DYN_FILTEREXACT = 0, 1, 2, 3

# Narrowphase collider keys (types sorted a <= b) -> contact points per
# pair, the JAX engine's table; physics/collision.py has a collider for
# every key. Mesh pairs collide against the precomputed convex hulls
# (physics/mesh.py): plane-mesh keeps the 4 deepest hull vertices, the
# others one point.
_COLLIDER_POINTS = {
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.PLANE, GeomType.ELLIPSOID): 1,
    (GeomType.PLANE, GeomType.CYLINDER): 4,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.SPHERE, GeomType.CYLINDER): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 1,
    (GeomType.CAPSULE, GeomType.BOX): 2,
    (GeomType.BOX, GeomType.BOX): 8,
    (GeomType.SPHERE, GeomType.ELLIPSOID): 1,
    (GeomType.CAPSULE, GeomType.ELLIPSOID): 1,
    (GeomType.CAPSULE, GeomType.CYLINDER): 1,
    (GeomType.ELLIPSOID, GeomType.ELLIPSOID): 1,
    (GeomType.ELLIPSOID, GeomType.CYLINDER): 1,
    (GeomType.ELLIPSOID, GeomType.BOX): 1,
    (GeomType.CYLINDER, GeomType.CYLINDER): 1,
    (GeomType.CYLINDER, GeomType.BOX): 1,
    (GeomType.HFIELD, GeomType.SPHERE): 3,
    (GeomType.HFIELD, GeomType.CAPSULE): 3,
    (GeomType.HFIELD, GeomType.BOX): 4,
    (GeomType.PLANE, GeomType.MESH): 4,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.MESH): 1,
    (GeomType.ELLIPSOID, GeomType.MESH): 1,
    (GeomType.CYLINDER, GeomType.MESH): 1,
    (GeomType.BOX, GeomType.MESH): 1,
    (GeomType.MESH, GeomType.MESH): 1,
}

_AUTO_NCON_CAP = 64


def resolve_device(device) -> torch.device:
  """The device an entry point was asked for. CUDA is the default of every
  entry point; asking for it on a host without a GPU is an error, never a
  silent move to the CPU."""
  dev = torch.device(device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        "CUDA is not available on this host; pass device='cpu' to run the "
        'engine on the CPU')
  return dev


def _body_levels(parentid: np.ndarray) -> tuple:
  nbody = len(parentid)
  depth = np.zeros(nbody, dtype=np.int32)
  for b in range(1, nbody):
    depth[b] = depth[parentid[b]] + 1
  levels = []
  for d in range(1, depth.max() + 1 if nbody > 1 else 1):
    ids = np.nonzero(depth == d)[0].astype(np.int32)
    if len(ids):
      levels.append(ids)
  return tuple(levels)


def _ancestor_mask(m) -> np.ndarray:
  """mask[b, d] = 1 if dof d belongs to body b or one of its ancestors."""
  mask = np.zeros((m.nbody, m.nv), dtype=np.float64)
  for b in range(m.nbody):
    cur = b
    while cur != 0:
      adr, num = m.body_dofadr[cur], m.body_dofnum[cur]
      if num > 0:
        mask[b, adr:adr + num] = 1.0
      cur = m.body_parentid[cur]
  return mask


def _subtree_mask(parentid: np.ndarray) -> np.ndarray:
  nbody = len(parentid)
  mask = np.zeros((nbody, nbody), dtype=np.float64)
  for c in range(nbody):
    cur = c
    mask[cur, c] = 1.0
    while cur != 0:
      cur = parentid[cur]
      mask[cur, c] = 1.0
  return mask


def _dof_prefix_mask(m, ancestor: np.ndarray) -> np.ndarray:
  """prefix[d, e] = 1 if dof e adds to the velocity that dof d sees when
  cdof_dot is formed (mj_comVel order: ancestor dofs, and for a free joint
  the translational dofs ahead of its rotational ones)."""
  nv = m.nv
  prefix = np.zeros((nv, nv), dtype=np.float64)
  for d in range(nv):
    b = m.dof_bodyid[d]
    j = m.dof_jntid[d]
    prefix[d] = ancestor[b]
    excl = m.jnt_dofadr[j]
    if m.jnt_type[j] == int(JointType.FREE):
      excl += 3
    adr, num = m.body_dofadr[b], m.body_dofnum[b]
    prefix[d, min(excl, d):adr + num] = 0.0
  return prefix


def _filter_pair(m, g1: int, g2: int) -> bool:
  """Static broadphase filter (mj_filterPair): contype/conaffinity,
  same-body and parent-child exclusion, and explicit <exclude>s."""
  b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
  if b1 == b2:
    return False
  if m.nexclude:
    sigs = m.exclude_signature
    if ((int(b1) << 16) + int(b2)) in sigs or \
       ((int(b2) << 16) + int(b1)) in sigs:
      return False
  w1, w2 = m.body_weldid[b1], m.body_weldid[b2]
  if w1 == w2:
    return False
  wp1 = m.body_weldid[m.body_parentid[w1]]
  wp2 = m.body_weldid[m.body_parentid[w2]]
  if (w1 == wp2 and w1 != 0) or (w2 == wp1 and w2 != 0):
    return False
  ok = (m.geom_contype[g1] & m.geom_conaffinity[g2]) or \
       (m.geom_contype[g2] & m.geom_conaffinity[g1])
  return bool(ok)


def _build_pairs(m) -> CollisionPairs:
  groups: dict = {}

  def add(g1: int, g2: int, pairid: int) -> None:
    t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
    a, b = (g1, g2) if t1 <= t2 else (g2, g1)
    key = (min(t1, t2), max(t1, t2))
    if key not in _COLLIDER_POINTS:
      raise NotImplementedError(
          f'no collider for geom type pair {GeomType(key[0]).name}-'
          f'{GeomType(key[1]).name} (geoms {g1},{g2})')
    groups.setdefault(key, ([], [], []))
    groups[key][0].append(a)
    groups[key][1].append(b)
    groups[key][2].append(pairid)

  # explicit <pair>s first, then the filtered dynamic pairs (MuJoCo order)
  explicit = set()
  for p in range(m.npair):
    g1, g2 = int(m.pair_geom1[p]), int(m.pair_geom2[p])
    explicit.add((min(g1, g2), max(g1, g2)))
    add(g1, g2, p)
  for g1 in range(m.ngeom):
    for g2 in range(g1 + 1, m.ngeom):
      if (g1, g2) in explicit or not _filter_pair(m, g1, g2):
        continue
      add(g1, g2, -1)
  ncon = 0
  final = {}
  for key in sorted(groups):
    g1s, g2s, pids = groups[key]
    final[key] = (np.asarray(g1s, np.int32), np.asarray(g2s, np.int32),
                  np.asarray(pids, np.int32), ncon, _COLLIDER_POINTS[key])
    ncon += len(g1s) * _COLLIDER_POINTS[key]
  return CollisionPairs(groups=final, ncon_max=ncon)


def contact_slot_meta(m, pairs: CollisionPairs):
  """Static per-contact-slot (geom1, geom2, condim) arrays."""
  geom1 = np.zeros(max(pairs.ncon_max, 1), np.int32)
  geom2 = np.zeros(max(pairs.ncon_max, 1), np.int32)
  dim = np.ones(max(pairs.ncon_max, 1), np.int32)
  for _, (g1s, g2s, pids, base, npts) in pairs.groups.items():
    for i, (g1, g2, pid) in enumerate(zip(g1s, g2s, pids)):
      if pid >= 0:
        condim = int(m.pair_dim[pid])
      else:
        p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
        if p1 != p2:
          condim = m.geom_condim[g1] if p1 > p2 else m.geom_condim[g2]
        else:
          condim = max(m.geom_condim[g1], m.geom_condim[g2])
      s = base + i * npts
      geom1[s:s + npts] = g1
      geom2[s:s + npts] = g2
      dim[s:s + npts] = condim
  return geom1, geom2, dim


def names_of(m, kind: str, n: int) -> tuple:
  """Names of the first n objects of a kind ('body', 'jnt', ...), from the
  model's name buffer; unnamed objects are '#<id>'."""
  buf = m.names if isinstance(m.names, bytes) else bytes(m.names)
  adr = getattr(m, f'name_{kind}adr')
  out = []
  for i in range(n):
    start = int(adr[i])
    name = buf[start:buf.index(b'\0', start)].decode()
    out.append(name or f'#{i}')
  return tuple(out)


_EQ_CONNECT, _EQ_WELD, _EQ_JOINT = 0, 1, 2  # mjtEq
_TRN_TENDON = 3  # mjtTrn.mjTRN_TENDON
_WRAP_JOINT, _WRAP_SITE = 1, 3  # mjtWrap
_INT_IMPLICIT, _INT_IMPLICITFAST = 2, 3  # mjtIntegrator


def _check_supported(m) -> None:
  """Model features outside this engine raise here, loudly (the JAX
  engine's build-time gates; `_parse_tendons` holds the tendons' own)."""
  unsupported = []
  for t in np.asarray(m.eq_type)[:m.neq]:
    if int(t) not in (_EQ_CONNECT, _EQ_WELD, _EQ_JOINT):
      unsupported.append(f'equality type {int(t)} (connect, weld and joint '
                         'are implemented)')
  dyn_ok = (_DYN_NONE, _DYN_INTEGRATOR, _DYN_FILTER, _DYN_FILTEREXACT)
  if m.na and any(int(t) not in dyn_ok for t in m.actuator_dyntype):
    unsupported.append('actuator dynamics other than integrator/filter/'
                       'filterexact')
  if m.na and (np.asarray(m.actuator_actnum) > 1).any():
    unsupported.append('multi-state actuators')
  if m.na and np.asarray(m.actuator_actearly).any():
    unsupported.append('actearly')
  if m.nhfield > 1:
    unsupported.append('more than one heightfield')
  if (m.opt.density != 0 or m.opt.viscosity != 0
      or np.any(np.asarray(m.opt.wind) != 0)):
    unsupported.append('fluid forces')
  if m.opt.enableflags & _ENBL_OVERRIDE:
    unsupported.append('contact override')
  if m.opt.noslip_iterations > 0:
    unsupported.append('noslip')
  if m.npair and (np.asarray(m.pair_solreffriction) != 0).any():
    unsupported.append('pair solreffriction')
  trn = [int(t) for t in m.actuator_trntype]
  if any(t not in (_TRN_JOINT, _TRN_TENDON) for t in trn):
    unsupported.append('actuator transmissions other than joint and tendon')
  if m.ntendon and int(m.opt.integrator) in (_INT_IMPLICIT,
                                             _INT_IMPLICITFAST):
    if (_TRN_TENDON in trn
        or (np.asarray(m.tendon_damping)[:m.ntendon] != 0).any()):
      unsupported.append(
          'implicit integrators with tendon damping or tendon actuators '
          '(their velocity derivative is not diagonal; use Euler)')
  for b in range(m.nbody):
    jn = m.body_jntnum[b]
    for j in range(m.body_jntadr[b], m.body_jntadr[b] + jn):
      if jn > 1 and m.jnt_type[j] == int(JointType.FREE):
        unsupported.append('free joint sharing a body')
  if unsupported:
    raise NotImplementedError(
        'not supported by mjlab_torch: ' + ', '.join(sorted(set(
            unsupported))))


def _parse_tendons(m) -> dict:
  """The static tendon structure (the JAX engine's): a fixed tendon (joint
  couplings on hinge or slide joints) becomes constant coefficient rows,
  a spatial tendon its chain of sites. Tendon frictionloss, wrapping
  geoms and pulleys raise."""
  nt = int(m.ntendon)
  n1 = max(nt, 1)
  out = dict(ntendon=nt, ten_is_fixed=np.zeros(n1, bool),
             ten_coef_q=np.zeros((n1, m.nq)),
             ten_coef_v=np.zeros((n1, m.nv)), ten_site_chains=(),
             ten_limited=np.zeros(n1, bool))
  if not nt:
    return out
  if (np.asarray(m.tendon_frictionloss)[:nt] != 0).any():
    raise NotImplementedError('tendon frictionloss is not supported')
  chains = []
  for t in range(nt):
    adr, num = int(m.tendon_adr[t]), int(m.tendon_num[t])
    wt = [int(w) for w in m.wrap_type[adr:adr + num]]
    if all(w == _WRAP_JOINT for w in wt):
      out['ten_is_fixed'][t] = True
      chains.append(())
      for w in range(adr, adr + num):
        j = int(m.wrap_objid[w])
        if int(m.jnt_type[j]) not in (int(JointType.HINGE),
                                      int(JointType.SLIDE)):
          raise NotImplementedError(
              'fixed tendons on joints other than hinge and slide are not '
              'supported')
        out['ten_coef_q'][t, int(m.jnt_qposadr[j])] += m.wrap_prm[w]
        out['ten_coef_v'][t, int(m.jnt_dofadr[j])] += m.wrap_prm[w]
    elif all(w == _WRAP_SITE for w in wt):
      if num < 2:
        raise NotImplementedError('a spatial tendon needs at least 2 sites')
      chains.append(tuple(int(m.wrap_objid[w])
                          for w in range(adr, adr + num)))
    else:
      raise NotImplementedError(
          'tendon wrapping geoms and pulleys are not supported (site chains '
          'and fixed joint couplings are)')
  out['ten_site_chains'] = tuple(chains)
  out['ten_limited'][:nt] = np.asarray(m.tendon_limited)[:nt].astype(bool)
  return out


def _note_elliptic_path(cone: int) -> int:
  """One-time note: an elliptic-cone model solves on the plain Newton
  (K1 for its Cholesky on the card); the Newton kernel K2 implements the
  pyramidal cost only, so this model class does not run it."""
  if cone == 1 and not getattr(_note_elliptic_path, 'done', False):
    _note_elliptic_path.done = True
    import warnings
    warnings.warn(
        "cone='elliptic' solves on the plain Newton with the SPD-solve "
        'kernel (K1); the Newton kernel (K2) is pyramidal-only and does '
        "not run, so expect lower throughput than cone='pyramidal'.",
        stacklevel=3)
  return cone


def _compaction_caps(pairs: CollisionPairs, slot_dims: np.ndarray,
                     ncon_cap):
  """Split the per-env contact capacity into the frictional and the
  frictionless pool (same rule as the JAX engine)."""
  n3_slots = int((slot_dims[:pairs.ncon_max] > 1).sum())
  n1_slots = int((slot_dims[:pairs.ncon_max] == 1).sum())
  auto = ncon_cap is None
  if auto:
    ncon_cap = _AUTO_NCON_CAP if pairs.ncon_max > _AUTO_NCON_CAP else 0
  ncon_cap = min(int(ncon_cap), pairs.ncon_max)
  if ncon_cap == pairs.ncon_max:
    ncon_cap = 0
  ncon_cap1 = 0
  if ncon_cap:
    if n1_slots == 0:
      ncon_cap = min(ncon_cap, n3_slots)
    elif n3_slots == 0:
      ncon_cap1, ncon_cap = min(ncon_cap, n1_slots), 0
    elif auto:
      ncon_cap, ncon_cap1 = min(32, n3_slots), min(16, n1_slots)
    else:
      ncon_cap1 = max(min(ncon_cap // 4, n1_slots), 1)
      ncon_cap = min(ncon_cap - ncon_cap1, n3_slots)
  return ncon_cap, ncon_cap1


def _hfield(m) -> dict:
  """The one heightfield's static sizes and its grid in meters (MuJoCo
  stores elevations normalized to [0, 1] and scales them by size[2]); a
  (1, 1) zero grid when the model has none."""
  if not m.nhfield:
    return dict(nhfield=0, hfield_nrow=0, hfield_ncol=0,
                hfield_size=np.zeros(4), hfield_geomid=-1,
                data=np.zeros((1, 1)))
  nrow, ncol = int(m.hfield_nrow[0]), int(m.hfield_ncol[0])
  size = np.asarray(m.hfield_size[0], np.float64).copy()
  data = np.asarray(m.hfield_data)[:nrow * ncol].reshape(nrow, ncol)
  data = data * size[2]
  geomid = -1
  for g in range(m.ngeom):
    if m.geom_type[g] == int(GeomType.HFIELD):
      geomid = g
  return dict(nhfield=1, hfield_nrow=nrow, hfield_ncol=ncol,
              hfield_size=size, hfield_geomid=geomid, data=data)


def _mesh_tables(m) -> dict:
  """The static mesh tables: each mesh geom's mesh id (-1 for the other
  geoms) and the hulls, kept only when a collidable geom carries a mesh,
  so a model compiled and its snapshot (which then has no mesh arrays)
  build the same tables. The JAX engine also keeps an hfield geom's hfield
  id in geom_dataid, which neither engine reads."""
  hulls = _mesh.build_hulls(m)
  mesh = np.asarray(m.geom_type) == int(GeomType.MESH)
  dataid = np.where(mesh, np.asarray(m.geom_dataid), -1) if hulls is not None \
      else np.full(int(m.ngeom), -1)
  return dict(geom_dataid=dataid.astype(np.int32), mesh_hulls=hulls)


def model_static(m, ncon_cap: 'int | None' = None
                 ) -> ModelStatic:
  """The host-side static tables of a compiled model."""
  _check_supported(m)
  tendons = _parse_tendons(m)
  hf = _hfield(m)
  pairs = _build_pairs(m)
  con_geom1, con_geom2, con_dim = contact_slot_meta(m, pairs)
  ncon_cap, ncon_cap1 = _compaction_caps(pairs, con_dim, ncon_cap)
  ancestor = _ancestor_mask(m)
  return ModelStatic(
      nq=int(m.nq), nv=int(m.nv), nu=int(m.nu), nbody=int(m.nbody),
      njnt=int(m.njnt), ngeom=int(m.ngeom), nsite=int(m.nsite),
      nsensor=int(m.nsensor), nsensordata=int(m.nsensordata),
      body_parentid=m.body_parentid.copy(),
      body_rootid=m.body_rootid.copy(),
      body_jntadr=m.body_jntadr.copy(),
      body_jntnum=m.body_jntnum.copy(),
      body_dofadr=m.body_dofadr.copy(),
      body_dofnum=m.body_dofnum.copy(),
      body_geomadr=m.body_geomadr.copy(),
      body_geomnum=m.body_geomnum.copy(),
      body_levels=_body_levels(m.body_parentid),
      ancestor_mask=ancestor,
      subtree_mask=_subtree_mask(m.body_parentid),
      dof_prefix_mask=_dof_prefix_mask(m, ancestor),
      jnt_type=m.jnt_type.copy(),
      jnt_qposadr=m.jnt_qposadr.copy(),
      jnt_dofadr=m.jnt_dofadr.copy(),
      jnt_bodyid=m.jnt_bodyid.copy(),
      jnt_limited=m.jnt_limited.copy(),
      jnt_actgravcomp=m.jnt_actgravcomp.copy(),
      dof_bodyid=m.dof_bodyid.copy(),
      dof_jntid=m.dof_jntid.copy(),
      geom_type=m.geom_type.copy(),
      geom_bodyid=m.geom_bodyid.copy(),
      geom_condim=m.geom_condim.copy(),
      geom_priority=m.geom_priority.copy(),
      site_bodyid=m.site_bodyid.copy(),
      actuator_trntype=m.actuator_trntype.copy(),
      actuator_trnid=m.actuator_trnid.copy(),
      actuator_gaintype=m.actuator_gaintype.copy(),
      actuator_biastype=m.actuator_biastype.copy(),
      actuator_ctrllimited=m.actuator_ctrllimited.copy(),
      actuator_forcelimited=m.actuator_forcelimited.copy(),
      sensor_type=m.sensor_type.copy(),
      sensor_datatype=m.sensor_datatype.copy(),
      sensor_objtype=m.sensor_objtype.copy(),
      sensor_objid=m.sensor_objid.copy(),
      sensor_reftype=m.sensor_reftype.copy(),
      sensor_refid=m.sensor_refid.copy(),
      sensor_adr=m.sensor_adr.copy(),
      sensor_dim=m.sensor_dim.copy(),
      sensor_intprm=m.sensor_intprm.copy(),
      integrator=int(m.opt.integrator),
      cone=_note_elliptic_path(int(m.opt.cone)),
      iterations=int(m.opt.iterations),
      ls_iterations=int(m.opt.ls_iterations),
      disableflags=int(m.opt.disableflags),
      pairs=pairs,
      con_geom1=con_geom1,
      con_geom2=con_geom2,
      con_dim=con_dim,
      body_names=names_of(m, 'body', m.nbody),
      jnt_names=names_of(m, 'jnt', m.njnt),
      geom_names=names_of(m, 'geom', m.ngeom),
      site_names=names_of(m, 'site', m.nsite),
      actuator_names=names_of(m, 'actuator', m.nu),
      sensor_names=names_of(m, 'sensor', m.nsensor),
      ncon_cap=ncon_cap,
      ncon_cap1=ncon_cap1,
      nmocap=int(m.nmocap),
      body_mocapid=m.body_mocapid.copy().astype(np.int32),
      na=int(m.na),
      actuator_dyntype=np.asarray(m.actuator_dyntype, np.int32),
      actuator_actadr=np.asarray(m.actuator_actadr, np.int32),
      actuator_actlimited=np.asarray(m.actuator_actlimited).astype(bool),
      **tendons,
      neq=int(m.neq),
      eq_type=np.asarray(m.eq_type, np.int32)[:m.neq].copy(),
      eq_obj1=np.asarray(m.eq_obj1id, np.int32)[:m.neq].copy(),
      eq_obj2=np.asarray(m.eq_obj2id, np.int32)[:m.neq].copy(),
      newton_tolerance=float(m.opt.tolerance),
      meaninertia=float(m.stat.meaninertia),
      **{k: v for k, v in hf.items() if k != 'data'},
      **_mesh_tables(m),
  )


_OPTION_FIELDS = tuple(f.name for f in dataclasses.fields(Option))
MODEL_FIELDS = tuple(f.name for f in dataclasses.fields(Model)
                     if f.name not in ('stat', 'opt'))


# Model fields of a model's equality constraints and tendons, with the
# (1, ...) placeholder each takes when the model has none (the JAX engine's)
_EQ_PLACEHOLDERS = {'eq_data': np.zeros((1, 11)), 'eq_solref': np.zeros((1, 2)),
                    'eq_solimp': np.zeros((1, 5)), 'eq_active0': np.zeros(1)}
_TENDON_PLACEHOLDERS = {
    'tendon_stiffness': np.zeros(1), 'tendon_damping': np.zeros(1),
    'tendon_lengthspring': np.zeros((1, 2)), 'tendon_range': np.zeros((1, 2)),
    'tendon_solref_lim': np.zeros((1, 2)),
    'tendon_solimp_lim': np.zeros((1, 5)), 'tendon_margin': np.zeros(1),
    'tendon_invweight0': np.ones(1)}


def _model_arrays(m) -> dict:
  out = {name: getattr(m, name) for name in MODEL_FIELDS
         if not name.startswith(('pair_', 'eq_', 'tendon_'))
         and name != 'hfield_data'}
  out['hfield_data'] = _hfield(m)['data']
  out.update({k: np.asarray(getattr(m, k), np.float64) if m.neq else v
              for k, v in _EQ_PLACEHOLDERS.items()})
  out.update({k: getattr(m, k) if m.ntendon else v
              for k, v in _TENDON_PLACEHOLDERS.items()})
  out.update(
      pair_friction=m.pair_friction if m.npair else np.zeros((1, 5)),
      pair_solref=m.pair_solref if m.npair else np.zeros((1, 2)),
      pair_solimp=m.pair_solimp if m.npair else np.zeros((1, 5)),
      pair_margin=m.pair_margin if m.npair else np.zeros(1),
      actuator_dynprm=(np.asarray(m.actuator_dynprm)[:, :3] if m.nu
                       else np.zeros((1, 3))),
      actuator_actrange=m.actuator_actrange if m.nu else np.zeros((1, 2)))
  out['opt'] = {name: getattr(m.opt, name) for name in _OPTION_FIELDS}
  return out


def model_from_numpy(arrays: dict, stat: ModelStatic, device='cuda',
                     dtype=torch.float32) -> Model:
  """Model from a dict of numpy leaves: one entry per Model field plus
  'opt', a dict of the Option fields. Extra entries are ignored."""
  dev = resolve_device(device)
  t = lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=dev)
  opt = Option(**{k: t(arrays['opt'][k]) for k in _OPTION_FIELDS})
  return Model(stat=stat, opt=opt,
               **{k: t(arrays[k]) for k in MODEL_FIELDS})


def put_model(m, device='cuda', dtype=torch.float32,
              ncon_cap: 'int | None' = None) -> Model:
  """Convert a compiled mujoco.MjModel (or its ModelArrays snapshot) to
  the engine Model on `device`.

  ncon_cap: per-env active-contact capacity for constraint assembly
  (runtime top-K over the static pair table). None = auto: no compaction
  for small pair tables, 64 when the table is larger."""
  return model_from_numpy(_model_arrays(m), model_static(m, ncon_cap),
                          device=device, dtype=dtype)


def make_data(model: Model, batch_size: int = 1, device='cuda') -> Data:
  """Allocate a batched Data at qpos0 with `batch_size` envs."""
  dev = resolve_device(device)
  if model.device.type != dev.type:
    raise ValueError(f'model lives on {model.device}, data asked for {dev}')
  s = model.stat
  dtype = model.dtype
  dev = model.device
  B = int(batch_size)
  z = lambda *shape: torch.zeros((B,) + shape, dtype=dtype, device=dev)

  def eye3(n):
    return torch.eye(3, dtype=dtype, device=dev).expand(B, n, 3, 3).clone()

  ncon = max(s.pairs.ncon_max, 1)
  contact = Contact(
      dist=torch.full((B, ncon), 1e10, dtype=dtype, device=dev),
      pos=z(ncon, 3), frame=eye3(ncon), friction=z(ncon, 5),
      solref=z(ncon, 2), solimp=z(ncon, 5), includemargin=z(ncon))
  xquat = z(s.nbody, 4)
  xquat[..., 0] = 1.0
  # mocap poses start at the bodies' model pose (mj_resetData)
  if s.nmocap:
    mocap = _ix(np.nonzero(s.body_mocapid >= 0)[0], dev)
    mocap_pos = model.body_pos[..., mocap, :].expand(B, s.nmocap, 3).clone()
    mocap_quat = model.body_quat[..., mocap, :].expand(B, s.nmocap,
                                                       4).clone()
  else:
    mocap_pos, mocap_quat = z(1, 3), z(1, 4)
    mocap_quat[..., 0] = 1.0
  nt = max(s.ntendon, 1)
  return Data(
      qpos=model.qpos0.expand(B, s.nq).clone(),
      qvel=z(s.nv), ctrl=z(s.nu), qacc=z(s.nv), qacc_warmstart=z(s.nv),
      time=z(), xfrc_applied=z(s.nbody, 6), qfrc_applied=z(s.nv),
      xpos=z(s.nbody, 3), xquat=xquat, xmat=eye3(s.nbody),
      xipos=z(s.nbody, 3), ximat=eye3(s.nbody),
      xanchor=z(max(s.njnt, 1), 3), xaxis=z(max(s.njnt, 1), 3),
      geom_xpos=z(s.ngeom, 3), geom_xmat=eye3(s.ngeom),
      site_xpos=z(max(s.nsite, 1), 3), site_xmat=eye3(max(s.nsite, 1)),
      subtree_com=z(s.nbody, 3), cinr=z(s.nbody, 6, 6), cdof=z(s.nv, 6),
      cdof_dot=z(s.nv, 6), cvel=z(s.nbody, 6),
      qM=z(s.nv, s.nv), qfrc_bias=z(s.nv), qfrc_passive=z(s.nv),
      qfrc_spring=z(s.nv), qfrc_damper=z(s.nv), qfrc_actuator=z(s.nv),
      qfrc_smooth=z(s.nv), qacc_smooth=z(s.nv), qfrc_constraint=z(s.nv),
      actuator_length=z(s.nu), actuator_velocity=z(s.nu),
      actuator_force=z(s.nu),
      contact=contact,
      efc_force=z(max(efc_layout(s).nefc, 1)),
      ncon_active=torch.zeros(B, dtype=torch.int32, device=dev),
      solver_niter=torch.zeros(B, dtype=torch.int32, device=dev),
      sensordata=z(max(s.nsensordata, 1)),
      act=z(max(s.na, 1)), act_dot=z(max(s.na, 1)),
      mocap_pos=mocap_pos, mocap_quat=mocap_quat,
      ten_length=z(nt), ten_velocity=z(nt), ten_J=z(nt, s.nv),
  )


def make_batched_data(model: Model, num_envs: int, device='cuda') -> Data:
  """Allocate (num_envs, ...) Data (counterpart of sim.make_batched_data)."""
  return make_data(model, batch_size=num_envs, device=device)


DATA_FIELDS = tuple(f.name for f in dataclasses.fields(Data)
                    if f.name != 'contact')
CONTACT_FIELDS = tuple(f.name for f in dataclasses.fields(Contact))
_INT_DATA_FIELDS = ('ncon_active', 'solver_niter')


def data_from_numpy(arrays: dict, model: Model) -> Data:
  """Batched Data from a dict of numpy leaves with a leading env axis: one
  entry per Data field plus 'contact', a dict of the Contact fields. Extra
  entries are ignored; scalar-per-env leaves may be (B,) or (B, 1)."""
  dev, dtype = model.device, model.dtype

  def t(name, x):
    x = np.asarray(x)
    if name in _INT_DATA_FIELDS:
      return torch.tensor(x.reshape(-1), dtype=torch.int32, device=dev)
    if name == 'time':
      x = x.reshape(-1)
    return torch.tensor(x, dtype=dtype, device=dev)

  contact = Contact(**{k: t(k, arrays['contact'][k])
                       for k in CONTACT_FIELDS})
  return Data(contact=contact,
              **{k: t(k, arrays[k]) for k in DATA_FIELDS})


_SNAPSHOT_SCALARS = ('nq', 'nv', 'nu', 'na', 'nbody', 'njnt', 'ngeom', 'nsite',
                     'nsensor', 'nsensordata', 'neq', 'ntendon', 'nhfield',
                     'nmocap', 'npair', 'nexclude', 'nkey')
_SNAPSHOT_OPT = ('timestep', 'gravity', 'impratio', 'tolerance',
                 'ls_tolerance', 'density', 'viscosity', 'wind',
                 'enableflags', 'disableflags', 'noslip_iterations',
                 'integrator', 'cone', 'iterations', 'ls_iterations')
SNAPSHOT_ARRAYS = (
    'qpos0', 'qpos_spring', 'body_parentid', 'body_rootid', 'body_weldid',
    'body_mocapid', 'body_jntadr', 'body_jntnum', 'body_dofadr',
    'body_dofnum', 'body_geomadr', 'body_geomnum', 'body_pos', 'body_quat',
    'body_ipos', 'body_iquat', 'body_mass', 'body_subtreemass',
    'body_inertia', 'body_invweight0', 'body_gravcomp', 'jnt_type',
    'jnt_qposadr', 'jnt_dofadr', 'jnt_bodyid', 'jnt_limited',
    'jnt_actgravcomp', 'jnt_pos', 'jnt_axis', 'jnt_range', 'jnt_stiffness',
    'jnt_solref', 'jnt_solimp', 'jnt_margin', 'dof_bodyid', 'dof_jntid',
    'dof_armature', 'dof_damping', 'dof_frictionloss', 'dof_invweight0',
    'dof_solref', 'dof_solimp', 'geom_type', 'geom_bodyid', 'geom_condim',
    'geom_priority', 'geom_contype', 'geom_conaffinity', 'geom_pos',
    'geom_quat', 'geom_size', 'geom_friction', 'geom_solref', 'geom_solimp',
    'geom_solmix', 'geom_margin', 'geom_gap', 'geom_rgba', 'site_bodyid',
    'site_pos', 'site_quat', 'actuator_trntype', 'actuator_trnid',
    'actuator_gaintype', 'actuator_biastype', 'actuator_ctrllimited',
    'actuator_forcelimited', 'actuator_gainprm', 'actuator_biasprm',
    'actuator_gear', 'actuator_ctrlrange', 'actuator_forcerange',
    'actuator_dyntype', 'actuator_actadr', 'actuator_actnum',
    'actuator_actearly', 'actuator_actlimited', 'actuator_dynprm',
    'actuator_actrange',
    'sensor_type', 'sensor_datatype', 'sensor_objtype', 'sensor_objid',
    'sensor_reftype', 'sensor_refid', 'sensor_adr', 'sensor_dim',
    'sensor_intprm', 'pair_dim', 'pair_geom1', 'pair_geom2',
    'pair_friction', 'pair_solref', 'pair_solimp', 'pair_margin',
    'pair_solreffriction', 'exclude_signature', 'key_qpos', 'key_ctrl',
    'names', 'name_bodyadr', 'name_jntadr', 'name_geomadr', 'name_siteadr',
    'name_actuatoradr', 'name_sensoradr')
# the heightfield's arrays, in a snapshot only when the model has one
HFIELD_ARRAYS = {
    'hfield_nrow': np.zeros(0, np.int32),
    'hfield_ncol': np.zeros(0, np.int32),
    'hfield_size': np.zeros((0, 4)),
    'hfield_data': np.zeros(0, np.float32),
}

# the mesh arrays the hulls are built from (physics/mesh.py), in a snapshot
# only when a collidable geom carries a mesh (_mesh_tables); nmesh is
# len(mesh_vertadr)
MESH_ARRAYS = {
    'geom_dataid': np.asarray(-1, np.int32),  # no geom has a mesh
    'mesh_vertadr': np.zeros(0, np.int32),
    'mesh_vertnum': np.zeros(0, np.int32),
    'mesh_vert': np.zeros((0, 3), np.float32),
}

# the arrays of equality constraints and tendons, in a snapshot only when
# the model has either, each with its value in a model that has none (a
# snapshot written before they were ported lacks them too)
EQ_TENDON_ARRAYS = {
    'eq_type': np.zeros(0, np.int32), 'eq_obj1id': np.zeros(0, np.int32),
    'eq_obj2id': np.zeros(0, np.int32), 'eq_data': np.zeros((0, 11)),
    'eq_solref': np.zeros((0, 2)), 'eq_solimp': np.zeros((0, 5)),
    'eq_active0': np.zeros(0, bool), 'tendon_adr': np.zeros(0, np.int32),
    'tendon_num': np.zeros(0, np.int32), 'tendon_limited': np.zeros(0, bool),
    'tendon_frictionloss': np.zeros(0), 'tendon_stiffness': np.zeros(0),
    'tendon_damping': np.zeros(0), 'tendon_lengthspring': np.zeros((0, 2)),
    'tendon_range': np.zeros((0, 2)), 'tendon_solref_lim': np.zeros((0, 2)),
    'tendon_solimp_lim': np.zeros((0, 5)), 'tendon_margin': np.zeros(0),
    'tendon_invweight0': np.zeros(0), 'wrap_type': np.zeros(0, np.int32),
    'wrap_objid': np.zeros(0, np.int32), 'wrap_prm': np.zeros(0),
}


class ModelArrays:
  """Read-only snapshot of the compiled-model fields the engine reads,
  with the attribute names of mujoco.MjModel (`opt` and `stat` nested).

  A snapshot of a task's scene also records the spec inputs it was
  composed from and their digest (`spec_inputs`, `spec_digest`; both
  made by scene/scene.py, which holds the cfg's inputs to them before it
  takes the snapshot)."""

  def __init__(self, arrays: dict):
    self._arrays = dict(arrays)
    for k in _SNAPSHOT_SCALARS:
      setattr(self, k, int(self._arrays[k]))
    self.opt = _Namespace({k: self._arrays[f'opt.{k}']
                           for k in _SNAPSHOT_OPT})
    self.stat = _Namespace({'meaninertia': self._arrays['stat.meaninertia']})
    for k in SNAPSHOT_ARRAYS:
      setattr(self, k, self._arrays[k])
    for k, empty in {**HFIELD_ARRAYS, **EQ_TENDON_ARRAYS,
                     **MESH_ARRAYS}.items():
      setattr(self, k, self._arrays.get(k, empty))
    self.nmesh = len(self.mesh_vertadr)
    inputs = self._arrays.get('spec_inputs')
    self.spec_inputs = None if inputs is None else tuple(
        str(x) for x in inputs)
    self.spec_digest = (None if inputs is None
                        else str(self._arrays['spec_digest']))

  def with_spec_inputs(self, inputs, digest: str) -> 'ModelArrays':
    """A copy that records the spec inputs `inputs` and their digest."""
    a = self.arrays()
    a['spec_inputs'] = np.asarray(list(inputs), dtype=str)
    a['spec_digest'] = np.asarray(digest)
    return ModelArrays(a)

  @classmethod
  def of(cls, m) -> 'ModelArrays':
    """Snapshot of a compiled mujoco.MjModel."""
    arrays = {k: np.asarray(getattr(m, k)) for k in SNAPSHOT_ARRAYS}
    arrays['names'] = np.frombuffer(m.names, dtype=np.uint8)
    arrays.update({k: np.asarray(getattr(m, k)) for k in _SNAPSHOT_SCALARS})
    arrays.update({f'opt.{k}': np.asarray(getattr(m.opt, k))
                   for k in _SNAPSHOT_OPT})
    arrays['stat.meaninertia'] = np.asarray(m.stat.meaninertia)
    if m.neq or m.ntendon:
      arrays.update({k: np.asarray(getattr(m, k)) for k in EQ_TENDON_ARRAYS})
    if m.nhfield:
      arrays.update({k: np.asarray(getattr(m, k)) for k in HFIELD_ARRAYS})
    if _mesh.collidable_meshes(m):
      arrays.update({k: np.asarray(getattr(m, k)) for k in MESH_ARRAYS})
    return cls(arrays)

  def save(self, path) -> None:
    np.savez_compressed(path, **self._arrays)

  @classmethod
  def load(cls, path) -> 'ModelArrays':
    with np.load(path, allow_pickle=False) as z:
      return cls({k: z[k] for k in z.files})

  def arrays(self) -> dict:
    return dict(self._arrays)


class _Namespace:

  def __init__(self, values: dict):
    for k, v in values.items():
      setattr(self, k, v[()] if np.ndim(v) == 0 else v)
