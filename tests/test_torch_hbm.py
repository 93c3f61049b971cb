"""The port's device-memory guard (mjlab_torch/utils/hbm.py) on the CPU,
the counterpart of tests/test_hbm_guard.py: nothing measured or checked
without CUDA; on a stand-in card (torch.cuda's memory calls replaced) the
report holds the allocator's peak over the call and the capacity, and
assert_fits raises when the capacity is patched small, with the facts of
the JAX guard's message, and returns the report when it is patched
large."""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

from mjlab_torch.utils import hbm
from mjlab_tpu.utils import hbm as jhbm

PEAK = 3 * 2**30


def test_the_cpu_checks_nothing():
  ran = []
  assert hbm.device_capacity('cpu') is None
  assert hbm.memory_report(lambda: ran.append(1), device='cpu') is None
  assert ran == []
  assert hbm.assert_fits(None, label='x') is None
  rep = hbm.MemoryReport(peak_bytes=PEAK, baseline_bytes=0,
                         capacity_bytes=None)
  assert hbm.assert_fits(rep, label='x') is rep  # capacity unknown
  assert hbm.DEFAULT_FRACTION == jhbm.DEFAULT_FRACTION


def test_no_cuda_means_no_report(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert hbm.device_capacity() is None
  assert hbm.memory_report(lambda: 1 / 0) is None


@pytest.fixture
def card(monkeypatch):
  """A stand-in card of 80 GiB whose allocator's peak over a call is
  PEAK bytes; records the calls made to it."""
  calls = []
  cuda = torch.cuda
  monkeypatch.setattr(cuda, 'is_available', lambda: True)
  monkeypatch.setattr(cuda, 'synchronize',
                      lambda dev=None: calls.append('sync'))
  monkeypatch.setattr(cuda, 'reset_peak_memory_stats',
                      lambda dev=None: calls.append('reset'))
  monkeypatch.setattr(cuda, 'memory_allocated', lambda dev=None: 2**20)
  monkeypatch.setattr(cuda, 'max_memory_allocated', lambda dev=None: PEAK)
  monkeypatch.setattr(cuda, 'mem_get_info',
                      lambda dev=None: (2**30, 80 * 2**30))
  return calls


def test_report_runs_the_function_once_between_the_reads(card):
  ran = []
  rep = hbm.memory_report(lambda x, y=0: ran.append((x, y)), 3, y=4)
  assert ran == [(3, 4)]
  assert card == ['sync', 'reset', 'sync']
  assert (rep.peak_bytes, rep.baseline_bytes, rep.capacity_bytes) == (
      PEAK, 2**20, 80 * 2**30)
  assert 'peak 3.00 GiB' in str(rep) and '80.00 GiB' in str(rep)


def test_capacity_falls_back_to_the_device_properties(card, monkeypatch):
  def no_info(dev=None):
    raise RuntimeError('no mem_get_info')
  monkeypatch.setattr(torch.cuda, 'mem_get_info', no_info)
  monkeypatch.setattr(torch.cuda, 'get_device_properties',
                      lambda dev: types.SimpleNamespace(total_memory=123))
  assert hbm.device_capacity() == 123


def _jax_overflow(label: str) -> str:
  """The JAX guard's message on a program it is told cannot fit."""
  compiled = jax.jit(lambda x: (x @ x).sum()).lower(
      jnp.ones((64, 64))).compile()
  if jhbm.memory_report(compiled) is None:
    pytest.skip('the JAX backend exposes no memory analysis')
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jhbm, 'device_capacity', lambda device=None: 16)
    with pytest.raises(jhbm.HbmWouldOverflowError) as e:
      jhbm.assert_fits(compiled, label=label)
  return str(e.value)


def test_assert_fits_raises_over_budget(card, monkeypatch):
  monkeypatch.setattr(hbm, 'device_capacity', lambda device=None: 16)
  rep = hbm.memory_report(lambda: None)
  with pytest.raises(hbm.HbmWouldOverflowError) as e:
    hbm.assert_fits(rep, label='env.step @8192')
  got = str(e.value)
  want = _jax_overflow('env.step @8192')
  # the JAX message's facts: the label, the fraction, the capacity, the
  # refusal; and the peak
  for fact in ('env.step @8192: ', 'exceeds 92% of device capacity 0.00 GiB',
               'refusing to execute'):
    assert fact in got and fact in want, fact
  assert 'peak device memory 3.00 GiB' in got


def test_assert_fits_passes_under_budget(card, monkeypatch):
  monkeypatch.setattr(hbm, 'device_capacity',
                      lambda device=None: PEAK * 10)
  rep = hbm.memory_report(lambda: None)
  assert hbm.assert_fits(rep, label='ok') is rep
  # at the fraction's edge: a peak of exactly 92 % fits, one byte more not
  edge = hbm.MemoryReport(int(PEAK * 0.92), 0, PEAK)
  assert hbm.assert_fits(edge) is edge
  with pytest.raises(hbm.HbmWouldOverflowError):
    hbm.assert_fits(hbm.MemoryReport(int(PEAK * 0.92) + 1, 0, PEAK))
