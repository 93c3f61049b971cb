"""The port's utils against the JAX package's: name resolvers, task math,
the circular buffer and the noise models on the same numpy inputs (float64,
1e-12), and the port's samplers alone: a range collapsed to a point gives
exactly that point, and an open range is filled as its distribution says."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.utils import buffers as jbuf
from mjlab_tpu.utils import math as jmath
from mjlab_tpu.utils import noise as jnoise
from mjlab_tpu.utils import string as jstr
from mjlab_tpu.utils.dataclasses import get_terms as jget_terms
from mjlab_torch.managers import term_cfg as tcfg
from mjlab_torch.utils import buffers as tbuf
from mjlab_torch.utils import math as tmath
from mjlab_torch.utils import noise as tnoise
from mjlab_torch.utils import string as tstr
from mjlab_torch.utils.dataclasses import get_terms as tget_terms

TOL = 1e-12
NAMES = ['left_hip_pitch_joint', 'left_knee_joint', 'right_hip_pitch_joint',
         'right_knee_joint', 'waist_yaw_joint']


def _close(got, want, what=''):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL,
                             err_msg=what)


@pytest.mark.parametrize('keys,preserve', [
    ('.*_knee_joint', False), (['waist.*', 'left_.*'], False),
    (['waist.*', 'left_.*'], True), ('.*', False)])
def test_resolve_matching_names(keys, preserve):
  assert tstr.resolve_matching_names(keys, NAMES, preserve) == \
      jstr.resolve_matching_names(keys, NAMES, preserve)
  assert tstr.resolve_expr(keys, NAMES) == jstr.resolve_expr(keys, NAMES)


def test_resolve_matching_names_values_and_errors():
  data = {'.*_knee_joint': 0.6, 'waist.*': -0.1}
  assert tstr.resolve_matching_names_values(data, NAMES) == \
      jstr.resolve_matching_names_values(data, NAMES)
  for fn in (tstr.resolve_matching_names, jstr.resolve_matching_names):
    with pytest.raises(ValueError, match='not found'):
      fn('elbow.*', NAMES)
    with pytest.raises(ValueError, match='multiple keys'):
      fn(['left_.*', '.*knee.*'], NAMES)


def test_get_terms_keeps_declaration_order_and_injected_terms():
  cfg = tcfg.ObservationGroupCfg()
  cfg.zeta = tcfg.ObservationTermCfg(func=len)
  cfg.alpha = tcfg.ObservationTermCfg(func=max)
  got = tget_terms(cfg, tcfg.ObservationTermCfg)
  assert list(got) == list(jget_terms(cfg, tcfg.ObservationTermCfg))
  assert list(got) == ['zeta', 'alpha']
  assert tget_terms(None, tcfg.ObservationTermCfg) == {}


def _quats(rng, n):
  q = rng.normal(size=(n, 4))
  return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize('name', ['quat_apply', 'quat_apply_inverse',
                                  'quat_mul', 'quat_conjugate',
                                  'quat_from_euler_xyz', 'wrap_to_pi'])
def test_math_matches_jax(name):
  rng = np.random.default_rng(0)
  q, p, v = _quats(rng, 7), _quats(rng, 7), rng.normal(size=(7, 3))
  args = {'quat_apply': (q, v), 'quat_apply_inverse': (q, v),
          'quat_mul': (q, p), 'quat_conjugate': (q,),
          'quat_from_euler_xyz': tuple(4 * rng.normal(size=(3, 7))),
          'wrap_to_pi': (20 * rng.normal(size=50),)}[name]
  got = getattr(tmath, name)(*[torch.as_tensor(a) for a in args])
  _close(got, getattr(jmath, name)(*[jnp.asarray(a) for a in args]), name)


def test_circular_buffer_matches_jax():
  """Appends, a masked reset in the middle (the next frame backfills that
  env's history), all_frames and lag, step by step."""
  rng = np.random.default_rng(1)
  n, length, dim = 3, 4, 2
  jcb = jbuf.create(n, length, dim, jnp.float64)
  tcb = tbuf.create(n, length, dim, torch.float64)
  for step in range(9):
    if step == 5:
      mask = np.array([False, True, False])
      jcb = jbuf.reset(jcb, jnp.asarray(mask))
      tcb = tbuf.reset(tcb, torch.as_tensor(mask))
    frame = rng.normal(size=(n, dim))
    before = tcb.buf.clone()
    jcb = jbuf.append(jcb, jnp.asarray(frame))
    new = tbuf.append(tcb, torch.as_tensor(frame))
    assert torch.equal(tcb.buf, before), 'append wrote into its argument'
    tcb = new
    _close(tcb.buf, jcb.buf, f'buf at step {step}')
    _close(tbuf.all_frames(tcb), jbuf.all_frames(jcb), f'frames at {step}')
    lags = np.array([0, 1, 3])
    _close(tbuf.lag(tcb, torch.as_tensor(lags)),
           jbuf.lag(jcb, jnp.asarray(lags)), f'lag at {step}')
    np.testing.assert_array_equal(tcb.count.numpy(), np.asarray(jcb.count))


def _gen(seed=0):
  return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize('op', ['add', 'scale', 'abs'])
def test_point_range_noise_matches_jax(op):
  """n_min == n_max and a constant bias: no value depends on the draw."""
  x = np.random.default_rng(2).normal(size=(5, 3))
  key = jax.random.PRNGKey(0)
  for jc, tc in ((jnoise.UniformNoiseCfg(op, 0.3, 0.3),
                  tnoise.UniformNoiseCfg(op, 0.3, 0.3)),
                 (jnoise.ConstantNoiseCfg(op, -0.2),
                  tnoise.ConstantNoiseCfg(op, -0.2)),
                 (jnoise.GaussianNoiseCfg(op, 0.1, 0.0),
                  tnoise.GaussianNoiseCfg(op, 0.1, 0.0))):
    _close(tnoise.apply_noise(tc, _gen(), torch.as_tensor(x)),
           jnoise.apply_noise(jc, key, jnp.asarray(x)), type(tc).__name__)
  xt = torch.as_tensor(x)
  assert tnoise.apply_noise(None, _gen(), xt) is xt


def test_bias_noise_model_matches_jax():
  x = np.random.default_rng(3).normal(size=(4, 2))
  mask = np.array([True, False, True, False])
  jc = jnoise.NoiseModelWithAdditiveBiasCfg(
      noise_cfg=jnoise.UniformNoiseCfg('add', 0.1, 0.1),
      bias_noise_cfg=jnoise.UniformNoiseCfg('abs', 0.5, 0.5))
  tc = tnoise.NoiseModelWithAdditiveBiasCfg(
      noise_cfg=tnoise.UniformNoiseCfg('add', 0.1, 0.1),
      bias_noise_cfg=tnoise.UniformNoiseCfg('abs', 0.5, 0.5))
  key = jax.random.PRNGKey(0)
  jb = jnoise.bias_reset(jc, key, jnoise.bias_init(jc, 4, 2, jnp.float64),
                         jnp.asarray(mask))
  tb = tnoise.bias_reset(tc, _gen(), tnoise.bias_init(4, 2, torch.float64),
                         torch.as_tensor(mask))
  _close(tb, jb, 'bias')
  assert float(tb[0, 0]) == 0.5 and float(tb[1, 0]) == 0.0
  _close(tnoise.bias_apply(tc, _gen(), torch.as_tensor(x), tb),
         jnoise.bias_apply(jc, key, jnp.asarray(x), jb), 'bias_apply')


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_samplers_point_range_is_exact(dtype):
  for a in (0.45, -3.14, 1e-3, 7.0):
    got = tmath.sample_uniform(_gen(), a, a, (1000,), dtype)
    assert bool((got == torch.tensor(a, dtype=dtype)).all()), a
  got = tmath.sample_log_uniform(_gen(), 2.0, 2.0, (1000,), torch.float64)
  assert float((got - 2.0).abs().max()) < 1e-15
  got = tmath.sample_gaussian(_gen(), 0.7, 0.0, (1000,), dtype)
  assert bool((got == torch.tensor(0.7, dtype=dtype)).all())


def test_samplers_fill_their_distributions():
  """Range, mean and spread from a seeded generator (20000 draws: the
  sample mean of a uniform on [lo, hi) lies within 0.02 of its centre with
  overwhelming odds)."""
  n = 20000
  u = tmath.sample_uniform(_gen(1), -0.5, 1.5, (n,), torch.float64)
  assert float(u.min()) >= -0.5 and float(u.max()) < 1.5
  assert abs(float(u.mean()) - 0.5) < 0.02
  assert abs(float(u.std()) - 2.0 / 12 ** 0.5) < 0.02
  lu = tmath.sample_log_uniform(_gen(2), 0.1, 10.0, (n,), torch.float64)
  assert float(lu.min()) >= 0.1 and float(lu.max()) <= 10.0
  assert abs(float(lu.log().mean())) < 0.05  # log-uniform: centred on 1
  g = tmath.sample_gaussian(_gen(3), 2.0, 0.5, (n,), torch.float64)
  assert abs(float(g.mean()) - 2.0) < 0.02 and abs(float(g.std()) - 0.5) < 0.02
  # the same seed gives the same stream; another seed another one
  again = tmath.sample_uniform(_gen(1), -0.5, 1.5, (n,), torch.float64)
  assert torch.equal(u, again)
  assert not torch.equal(u, tmath.sample_uniform(_gen(4), -0.5, 1.5, (n,),
                                                 torch.float64))
  noisy = tnoise.apply_noise(tnoise.UniformNoiseCfg('add', -0.1, 0.1),
                             _gen(5), torch.zeros(n, dtype=torch.float64))
  assert float(noisy.abs().max()) <= 0.1 and float(noisy.std()) > 0.05
