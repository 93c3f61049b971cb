"""Forward dynamics pipeline and integrators (the engine's `step`).

Counterpart of mjlab_tpu/physics/pipeline.py, natively batched: `step(m, d)`
advances every env of `d` by one timestep. One substep runs

  smooth_all (K3) -> collision -> tendon -> transmission -> passive ->
  actuation -> fwd_smooth (K1) -> make_efc -> solve (K2) -> sensors ->
  integrator (K1).

Supported integrators: Euler (implicit joint damping, as MuJoCo's
eulerdamp) and implicitfast (implicit in velocity through the diagonal
damping and actuator velocity-derivative terms).
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_torch.ops import pd_solve as _pd_solve
from mjlab_torch.physics import collision as _collision
from mjlab_torch.physics import constraint as _constraint
from mjlab_torch.physics import kinematics as _kinematics
from mjlab_torch.physics import math as pmath
from mjlab_torch.physics import sensor as _sensor
from mjlab_torch.physics import smooth as _smooth
from mjlab_torch.physics import smooth_fused as _smooth_fused
from mjlab_torch.physics import solver as _solver
from mjlab_torch.physics.tables import ix as _ix
from mjlab_torch.physics.tables import table
from mjlab_torch.physics.types import (
    Data,
    DisableBit,
    IntegratorType,
    JointType,
    Model,
)


def fwd_position(m: Model, d: Data) -> Data:
  if _smooth_fused.enabled(m.stat):
    # kinematics + com_pos + com_vel + crb + rne in one stage (K3)
    d = _smooth_fused.smooth_all(m, d)
  else:
    d = _kinematics.kinematics(m, d)
    d = _kinematics.com_pos(m, d)
    d = _smooth.crb(m, d)
  d = _collision.collision(m, d)
  d = _smooth.tendon(m, d)
  return _smooth.transmission(m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
  fused = _smooth_fused.enabled(m.stat)
  if not fused:
    d = _kinematics.com_vel(m, d)
  d = _smooth.passive(m, d)
  if not fused:
    d = _smooth.rne(m, d)
  return d


def forward(m: Model, d: Data) -> Data:
  """Full forward dynamics: position -> velocity -> actuation ->
  constraint -> sensors."""
  d = fwd_position(m, d)
  d = fwd_velocity(m, d)
  d = _smooth.actuation(m, d)
  d = _smooth.fwd_smooth(m, d)
  efc = _constraint.make_efc(m, d)
  d = _solver.solve(m, d, efc)
  d = d.replace(qacc_warmstart=d.qacc)
  return _sensor.sensors(m, d)


def _actuator_vel_deriv(m: Model, d: Data) -> torch.Tensor:
  """d qfrc_actuator / d qvel (diagonal), for implicitfast."""
  s = m.stat
  if s.nu == 0 or (s.disableflags & DisableBit.ACTUATION):
    return torch.zeros_like(d.qvel)
  dev = d.qpos.device
  ctrl = _smooth.clamp_ctrl(m, d.ctrl)
  if s.na:
    ctrl, _ = _smooth.act_input(m, d, ctrl)
  fixed = table(s.actuator_gaintype == 0, torch.bool, dev)
  affine = table(s.actuator_biastype == 1, torch.bool, dev)
  zero = torch.zeros((), dtype=ctrl.dtype, device=dev)
  gain_vel = torch.where(fixed, zero, m.actuator_gainprm[:, 2])
  bias_vel = torch.where(affine, m.actuator_biasprm[:, 2], zero)
  dforce_dvel = gain_vel * ctrl + bias_vel
  # saturated actuators have zero derivative
  gain, bias = _smooth.gain_bias(m, d)
  force = gain * ctrl + bias
  limited = table(s.actuator_forcelimited, torch.bool, dev)
  clamped = limited & ((force <= m.actuator_forcerange[:, 0])
                       | (force >= m.actuator_forcerange[:, 1]))
  dforce_dvel = torch.where(clamped, zero, dforce_dvel)
  gear = m.actuator_gear[:, 0]
  _, dadr, _, ten = _smooth.trn_tables(s, dev)
  if ten is not None:  # io.put_model refuses tendon actuators under
    dforce_dvel = torch.where(ten, zero, dforce_dvel)  # implicit ones
  return torch.zeros_like(d.qvel).index_add(1, dadr,
                                            gear * gear * dforce_dvel)


def _integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                   dt) -> torch.Tensor:
  """mj_integratePos: joint-type-aware position integration."""
  s = m.stat
  dev = qpos.device
  out = qpos.clone()
  for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
             JointType.HINGE):
    jsel = np.nonzero(s.jnt_type == int(jt))[0]
    if len(jsel) == 0:
      continue
    qadr = s.jnt_qposadr[jsel]
    dadr = s.jnt_dofadr[jsel]
    if jt in (JointType.HINGE, JointType.SLIDE):
      tq = _ix(qadr, dev)
      out[:, tq] = out[:, tq] + dt * qvel[:, _ix(dadr, dev)]
      continue
    r0 = 0
    if jt == JointType.FREE:
      tq = _ix(qadr[:, None] + np.arange(3), dev)
      out[:, tq] = out[:, tq] + dt * qvel[:, _ix(dadr[:, None]
                                                 + np.arange(3), dev)]
      r0 = 3
    tq = _ix(qadr[:, None] + r0 + np.arange(4), dev)
    w = qvel[:, _ix(dadr[:, None] + r0 + np.arange(3), dev)]
    out[:, tq] = pmath.quat_integrate(qpos[:, tq], w, dt)
  return out


def _advance_act(m: Model, d: Data, dt) -> Data:
  """Integrate actuator activations: Euler for integrator/filter, the
  exact exponential for filterexact; clamp to actrange (mj_advance)."""
  s = m.stat
  if not s.na:
    return d
  asel, ta, ti = _smooth.act_groups(s, d.qpos.device)
  dot = d.act_dot[:, ti]
  tau = m.actuator_dynprm[ta, 0].clamp_min(1e-15)
  exact = table(s.actuator_dyntype[asel] == _smooth._DYN_FILTEREXACT,
                torch.bool, dot.device)
  inc = torch.where(exact, dot * tau * (1.0 - torch.exp(-dt / tau)),
                    dt * dot)
  act_u = d.act[:, ti] + inc
  rng = m.actuator_actrange[ta]
  limited = table(s.actuator_actlimited[asel], torch.bool, dot.device)
  act_u = torch.where(limited, torch.minimum(torch.maximum(
      act_u, rng[:, 0]), rng[:, 1]), act_u)
  act = d.act.clone()
  act[:, ti] = act_u
  return d.replace(act=act)


def _implicit_solve(m: Model, d: Data, deriv: torch.Tensor) -> Data:
  """(M + dt diag(deriv)) qacc = qfrc_smooth + qfrc_constraint (K1), then
  integrate velocity and position."""
  dt = m.opt.timestep
  A = d.qM + dt * torch.diag_embed(deriv)
  qacc = _pd_solve.solve_pd(A, d.qfrc_smooth + d.qfrc_constraint)
  qvel = d.qvel + dt * qacc
  qpos = _integrate_pos(m, d.qpos, qvel, dt)
  return d.replace(qpos=qpos, qvel=qvel, time=d.time + dt)


def _euler(m: Model, d: Data) -> Data:
  d = _advance_act(m, d, m.opt.timestep)
  if m.stat.disableflags & DisableBit.EULERDAMP:
    dt = m.opt.timestep
    qvel = d.qvel + dt * d.qacc
    return d.replace(qpos=_integrate_pos(m, d.qpos, qvel, dt), qvel=qvel,
                     time=d.time + dt)
  # implicit joint damping: (M + dt*diag(B)) a = qfrc_smooth + qfrc_constr.
  return _implicit_solve(m, d, m.dof_damping.expand_as(d.qvel))


def _implicitfast(m: Model, d: Data) -> Data:
  d = _advance_act(m, d, m.opt.timestep)
  # M + dt*diag(damping - dforce/dqvel) is SPD for PD actuators
  return _implicit_solve(m, d, m.dof_damping - _actuator_vel_deriv(m, d))


def step(m: Model, d: Data) -> Data:
  """forward + integrate (mj_step analog), for every env of the batch."""
  d = forward(m, d)
  if m.stat.integrator == int(IntegratorType.EULER):
    return _euler(m, d)
  if m.stat.integrator == int(IntegratorType.IMPLICITFAST):
    return _implicitfast(m, d)
  raise NotImplementedError(
      f'integrator {IntegratorType(m.stat.integrator).name} not supported; '
      'use Euler or implicitfast')
