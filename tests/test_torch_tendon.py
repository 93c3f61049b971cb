"""Parity of the port's tendons with the JAX package, float64 on the CPU,
on the engine's tendon oracle model (mjlab_torch/asset_zoo/oracle_models.py,
the MJCF of tests/test_tendon.py: a fixed tendon coupling two hinges and a
spatial cable over three sites, both limited, with deadband springs and
dampers, a motor on the cable, a free box on the floor): lengths,
Jacobians, velocities, passive forces, the tendon transmission and the
tendon-limit rows of 3 envs in different states; a 100-step rollout under
random controls with the limits engaged, against the JAX engine and
MuJoCo; the contact rows, which the reference places late in its block;
the build-time gates both packages share."""

import functools

import jax
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.physics import constraint as jcon
from mjlab_tpu.physics import io as jio
from mjlab_tpu.physics import pipeline as jpipe
from mjlab_tpu.physics import smooth as jsmooth
import mjlab_torch.physics as tphys
from mjlab_torch.asset_zoo import oracle_models as om
from mjlab_torch.physics import constraint as tcon
from mjlab_torch.physics import pipeline as tpipe
from mjlab_torch.physics import smooth as tsmooth
from torch_parity import assert_close, oracle_pair, port_data, quick_jit

N = 3
TOL = 1e-9
ROLLOUT_TOL = 1e-8
T_KEYS = ('t_J', 't_D', 't_aref', 't_active', 't_pos')
# hinge angles (j1, j2) of the 3 envs: the coupling's limit (|j1 - j2/2|
# <= 0.5) engaged in the last two
HINGES = np.asarray([[0.0, 0.0], [0.6, -0.3], [1.2, 0.8]])


@functools.cache
def _model():
  return om.oracle_model('tendon')


def _state(seed=0):
  mj = _model()
  rng = np.random.default_rng(seed)
  qpos = np.tile(mj.qpos0, (N, 1))
  qpos[:, :2] = HINGES
  qvel = rng.uniform(-0.5, 0.5, (N, mj.nv))
  ctrl = rng.uniform(-2.0, 2.0, (N, mj.nu))
  return qpos, qvel, ctrl


def _stages(m, d):
  pos = jpipe.fwd_position(m, d)
  d = jpipe.fwd_velocity(m, pos)
  d = jsmooth.fwd_smooth(m, jsmooth.actuation(m, d))
  return pos, d, jcon.make_efc(m, d)


@functools.cache
def _jax(fn):
  return quick_jit(jax.vmap(fn, in_axes=(None, 0)))


def test_tendon_stages_match_jax():
  mj = _model()
  jm, jd, tm, td = oracle_pair(mj, *_state())
  assert tm.stat.ntendon == 2 and tm.stat.ten_site_chains == ((), (0, 1, 2))
  jpos, jfs, efc = _jax(_stages)(jm, jd)
  # lengths, Jacobians and velocities (fwd_position: tendon, then the
  # transmission)
  pos = tpipe.fwd_position(tm, td)
  for f in ('ten_length', 'ten_J', 'ten_velocity', 'actuator_length',
            'actuator_velocity'):
    assert_close(getattr(pos, f), getattr(jpos, f), TOL, f)
  # spring (deadband) and damper forces, the tendon actuator's force
  fs = tsmooth.fwd_smooth(tm, tsmooth.actuation(tm, tpipe.fwd_velocity(
      tm, pos)))
  for f in ('qfrc_spring', 'qfrc_damper', 'qfrc_passive', 'actuator_force',
            'qfrc_actuator', 'qacc_smooth'):
    assert_close(getattr(fs, f), getattr(jfs, f), TOL, f)
  # the tendon-limit rows
  tefc = tcon.make_efc(tm, port_data(tm, jfs))
  assert tefc['t_active'][1:].any(-1).all() and not tefc['t_active'][0].any()
  for k in T_KEYS:
    assert_close(tefc[k], efc[k], TOL, k)


def test_contact_rows_are_the_references_shifted():
  """The reference's make_efc puts the contact rows of a model without
  compaction at c-block row con_base - (nf + nl), which leaves out the
  equality and tendon-limit rows ahead of them: its block starts with
  ne + nlt empty rows and loses its last ne + nlt rows (here the last
  capsule-box point's second friction axis). The port's rows start at
  the block's head; the rows both have are equal."""
  mj = _model()
  jm, jd, tm, _ = oracle_pair(mj, *_state())
  _, jfs, efc = _jax(_stages)(jm, jd)
  tefc = tcon.make_efc(tm, port_data(tm, jfs))
  lay = tcon.efc_layout(tm.stat)
  k = lay.ne + lay.nlt
  assert k == 2 and lay.ncr == tefc['c_J'].shape[1] == efc['c_J'].shape[1]
  assert not np.asarray(efc['c_active'])[:, :k].any()
  assert float(np.abs(np.asarray(efc['c_J'])[:, :k]).max()) == 0.0
  for key in ('c_J', 'c_D', 'c_aref', 'c_active', 'c_pos'):
    assert_close(tefc[key][:, :lay.ncr - k], np.asarray(efc[key])[:, k:],
                 TOL, key)
  assert float(tefc['c_J'][:, lay.ncr - k:].abs().max()) > 0


def test_rollout_matches_jax_and_mujoco():
  """100 steps under random controls (env 0 winching the cable in hard, as
  test_tendon_limit_engages) from states whose coupling is past its limit
  (its rows active), against the JAX engine and MuJoCo (env 1). The
  hinges' own limits (+-1.5 and +-2 degrees) hold the tendons well inside
  their ranges once they have pulled the joints back."""
  mj = _model()
  md = mujoco.MjData(mj)
  qpos, qvel, _ = _state(1)
  md.qpos[:], md.qvel[:] = qpos[1], qvel[1]
  jm, jd, tm, td = oracle_pair(mj, qpos, qvel)
  active = tcon.make_efc(tm, tphys.forward(tm, td))['t_active']
  assert active[1:, 0].all() and not active[0].any()
  step = _jax(jpipe.step)
  rng = np.random.default_rng(2)
  for _ in range(100):
    ctrl = rng.uniform(-2.0, 2.0, (N, mj.nu))
    ctrl[0] = [-5.0, 0.0]
    md.ctrl[:] = ctrl[1]
    mujoco.mj_step(mj, md)
    jd = step(jm, jd.replace(ctrl=jax.numpy.asarray(ctrl)))
    td = tphys.step(tm, td.replace(ctrl=torch.as_tensor(ctrl)))
  assert_close(td.qpos, jd.qpos, ROLLOUT_TOL, 'qpos')
  assert_close(td.qvel, jd.qvel, ROLLOUT_TOL, 'qvel')
  assert_close(td.ten_length, jd.ten_length, ROLLOUT_TOL, 'ten_length')
  # efc_force: the rows ahead of the contacts equal, the contact rows the
  # reference's moved by its two empty rows (see the test above)
  lay = tcon.efc_layout(tm.stat)
  r0, k = lay.con_row0, lay.ne + lay.nlt
  jf = np.asarray(jd.efc_force)
  assert_close(td.efc_force[:, :r0], jf[:, :r0], ROLLOUT_TOL, 'efc_force')
  assert_close(td.efc_force[:, r0:lay.nefc - k], jf[:, r0 + k:], ROLLOUT_TOL,
               'efc_force, contact rows')
  assert float(np.abs(jf[:, r0 + k:]).max()) > 0  # the box is on the floor
  assert_close(td.qpos[1], md.qpos, ROLLOUT_TOL, 'qpos against MuJoCo')
  assert_close(td.ten_length[1], md.ten_length, ROLLOUT_TOL,
               'ten_length against MuJoCo')
  assert float(td.ten_length[:, 1].max()) < 0.75


WRAP_XML = """
<mujoco>
  <worldbody>
    <site name="a" pos="0 0 1"/>
    <geom name="cyl" type="cylinder" size="0.05 0.2" pos="0.2 0 0.5"/>
    <body pos="0.4 0 0.2"><freejoint/>
      <geom type="sphere" size="0.05" mass="0.1"/>
      <site name="b" pos="0 0 0"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t">
      <site site="a"/>
      <geom geom="cyl"/>
      <site site="b"/>
    </spatial>
  </tendon>
</mujoco>"""


@pytest.mark.parametrize('case', ['wrapping', 'frictionloss',
                                  'implicitfast'])
def test_unsupported_tendons_raise_in_both(case):
  if case == 'wrapping':
    mj = mujoco.MjModel.from_xml_string(WRAP_XML)
  elif case == 'frictionloss':
    mj = om.compile_model(om.TENDON_XML.replace(
        'damping="0.2" springlength', 'damping="0.2" frictionloss="0.1" '
        'springlength'))
  else:  # tendon damping and a tendon actuator under an implicit integrator
    mj = om.compile_model(om.TENDON_XML.replace('integrator="Euler"',
                                                'integrator="implicitfast"'))
  with pytest.raises(NotImplementedError):
    jio.put_model(mj)
  with pytest.raises(NotImplementedError):
    tphys.put_model(mj, device='cpu')
