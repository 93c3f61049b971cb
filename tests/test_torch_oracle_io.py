"""The snapshots and the Data leaves of equality constraints, tendons and
mocap bodies: the four committed scene snapshots, written before these
arrays were read, load as the same Model as with the arrays of a model
without equality constraints or tendons; the oracle models' committed
snapshots are their compiles; the new Data leaves (mocap_pos, mocap_quat,
ten_length, ten_velocity, ten_J) ride the env axis through
data_from_numpy, the env's sanitize, a rank's rows and gather_env."""

import dataclasses

import numpy as np
import pytest
import torch

import mjlab_torch.physics as tphys
from mjlab_torch import asset_zoo
from mjlab_torch.asset_zoo import oracle_models as om
from mjlab_torch.envs.manager_based_rl_env import sanitize
from mjlab_torch.parallel import sharding as tsh
from mjlab_torch.physics import io as tio

SCENES = {'g1_flat': asset_zoo.SNAPSHOTS[asset_zoo.G1_FLAT],
          'go1_flat': asset_zoo.SNAPSHOTS[asset_zoo.GO1_FLAT],
          'g1_tracking': asset_zoo.SNAPSHOTS[asset_zoo.G1_TRACKING],
          'tiny_flat': asset_zoo.SNAPSHOTS[asset_zoo.TINY_FLAT]}
NEW_LEAVES = ('mocap_pos', 'mocap_quat', 'ten_length', 'ten_velocity',
              'ten_J')


def _same_model(a, b):
  assert a.stat == b.stat
  for f in tio.MODEL_FIELDS:
    assert torch.equal(getattr(a, f), getattr(b, f)), f
  for f in tio._OPTION_FIELDS:
    assert torch.equal(getattr(a.opt, f), getattr(b.opt, f)), f


@pytest.mark.parametrize('scene', sorted(SCENES))
def test_committed_snapshot_loads_unchanged(scene):
  """The file lacks the equality and tendon arrays; with them added as a
  model without either has them, the Model is the same, and has no
  equality rows, tendons or mocap bodies."""
  old = tio.ModelArrays.load(SCENES[scene])
  saved = old.arrays()
  assert not set(tio.EQ_TENDON_ARRAYS) & set(saved)
  new = tio.ModelArrays({**saved, **tio.EQ_TENDON_ARRAYS})
  a = tphys.put_model(old, device='cpu', dtype=torch.float64)
  _same_model(a, tphys.put_model(new, device='cpu', dtype=torch.float64))
  s = a.stat
  assert (s.neq, s.ntendon, s.nmocap) == (0, 0, 0)
  assert tphys.constraint.efc_layout(s).ne == 0
  assert a.eq_data.shape == (1, 11) and a.tendon_invweight0.shape == (1,)


@pytest.mark.parametrize('name', om.NAMES)
def test_oracle_snapshot_is_the_compile(name):
  mj = om.oracle_model(name)
  fresh = tio.ModelArrays.of(mj).arrays()
  saved = om.oracle_arrays(name).arrays()
  assert sorted(fresh) == sorted(saved)
  for k in fresh:
    np.testing.assert_array_equal(saved[k], fresh[k], err_msg=k)
  _same_model(tphys.put_model(om.oracle_arrays(name), device='cpu'),
              tphys.put_model(mj, device='cpu'))


def _data(name, n):
  m = tphys.put_model(om.oracle_arrays(name), device='cpu',
                      dtype=torch.float64)
  d = tphys.make_batched_data(m, n, device='cpu')
  g = torch.Generator().manual_seed(0)
  return m, d.replace(**{k: torch.randn(getattr(d, k).shape, generator=g,
                                        dtype=torch.float64)
                         for k in NEW_LEAVES})


@pytest.mark.parametrize('name', ['mocap_weld', 'tendon'])
def test_new_leaves_ride_the_env_axis(name):
  m, d = _data(name, 4)
  s = m.stat
  assert d.mocap_pos.shape == (4, max(s.nmocap, 1), 3)
  assert d.ten_J.shape == (4, max(s.ntendon, 1), s.nv)
  assert set(NEW_LEAVES) <= set(tio.DATA_FIELDS)
  # numpy carry-across
  arrays = {k: getattr(d, k).numpy() for k in tio.DATA_FIELDS}
  arrays['contact'] = {k: getattr(d.contact, k).numpy()
                       for k in tio.CONTACT_FIELDS}
  back = tio.data_from_numpy(arrays, m)
  for k in NEW_LEAVES:
    assert torch.equal(getattr(back, k), getattr(d, k)), k
  # the env's sanitize: every float leaf, these too
  bad = d.replace(**{k: getattr(d, k).clone().index_fill_(0, torch.tensor(
      [2]), float('nan')) for k in NEW_LEAVES})
  clean = sanitize(bad)
  for k in NEW_LEAVES:
    assert torch.equal(getattr(clean, k)[:2], getattr(d, k)[:2])
    assert float(getattr(clean, k)[2].abs().max()) == 0.0
  # a rank's rows, and back through gather_env (a world of one on gloo)
  half = tsh.shard_batched(d, tsh.World(4, torch.device('cpu'), rank=1,
                                        size=2))
  for k in NEW_LEAVES:
    assert torch.equal(getattr(half, k), getattr(d, k)[2:]), k
  tsh.check_env_axes(dataclasses.asdict(d), tsh.World(
      4, torch.device('cpu')))
  world = tsh.init_world(4, device='cpu')
  try:
    assert world.sharded
    whole = tsh.gather_env(d, world)
  finally:
    tsh.close_world(world)
  for k in NEW_LEAVES:
    assert torch.equal(getattr(whole, k), getattr(d, k)), k

