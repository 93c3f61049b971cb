"""The port's physics-blowup tools against the JAX package's, on the CPU.

- NanGuard on the same seeded fake step as tests/test_nan_guard.py, in
  both modes: the dumps are equal array for array, the guard is one-shot,
  and a finite run dumps nothing.
- The forensic ring: `_forensic_write` on the same seeded inputs over
  several writes (more bad envs than captures a step, a wrap past the
  ring's end) and `maybe_dump_forensics`' payload, each method called on a
  stand-in `self` of both packages, with the host count re-synced by
  `reset`.
- The G1 flat env at 2 envs with one env's base spun up mid-rollout: the
  guard fires with that env on the state before the self-heal, the ring
  holds its pre-substep state bit for bit (and the layout of the JAX
  package's own round-4 ring), a checkpoint and the env's generator are
  the same with the ring on and off, and blowup_replay repeats the
  captured qvel peaks.
- nan_viz prints the JAX script's report; `scripts.train
  --enable-nan-guard` trains and dumps nothing on a healthy run.

The JAX guard on the JAX env's step never sees a non-finite state (the
env's self-heal comes first): tools/nan_guard_self_heal.py shows it, a JAX
env build being too slow for a test here.
"""

import dataclasses
import glob
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from mjlab_tpu.envs.manager_based_rl_env import ManagerBasedRlEnv as JaxEnv
from mjlab_tpu.scripts import nan_viz as jax_nan_viz
from mjlab_tpu.utils.nan_guard import NanGuard as JaxGuard
from mjlab_torch.envs.manager_based_rl_env import ManagerBasedRlEnv
from mjlab_torch.rl.runner import OnPolicyRunner
from mjlab_torch.scripts import blowup_replay, nan_viz, train
from mjlab_torch.tasks import registry
from mjlab_torch.utils.nan_guard import NanGuard
from torch_parity import G1_FLAT_TASK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R4_RING = os.path.join(ROOT, 'artifacts', 'blowups_r4', 'blowup_ring.npz')
SPIN = 1e5  # rad/s about the base's axes: blows up within a control step


def _npz(path):
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def _same_arrays(got: dict, want: dict):
  assert list(got) == list(want)
  for k, v in want.items():
    assert got[k].dtype == v.dtype, (k, got[k].dtype, v.dtype)
    assert got[k].shape == v.shape, (k, got[k].shape, v.shape)
    np.testing.assert_array_equal(got[k], v, err_msg=k)


# --------------------------------------------------------------------------
# (a) NanGuard on a fake step
# --------------------------------------------------------------------------


@struct.dataclass
class _JaxData:
  qpos: jax.Array
  qvel: jax.Array
  qacc: jax.Array
  time: jax.Array


@struct.dataclass
class _JaxState:
  data: _JaxData
  common_step: jax.Array


@dataclasses.dataclass
class _Data:
  qpos: torch.Tensor
  qvel: torch.Tensor
  qacc: torch.Tensor
  time: torch.Tensor


@dataclasses.dataclass
class _State:
  data: _Data
  common_step: torch.Tensor


N_ENVS, NQ, STEPS = 4, 3, 7


def _inputs(seed=0):
  rng = np.random.default_rng(seed)
  return (rng.normal(size=(3, N_ENVS, NQ)),
          rng.normal(size=(STEPS, N_ENVS, NQ)))


def _jax_step(nan_step, nan_env):
  def step(state, action):
    d = state.data
    qpos = d.qpos + action
    inject = (state.common_step >= nan_step) & (
        jnp.arange(N_ENVS) == nan_env)[:, None]
    qpos = jnp.where(inject, jnp.nan, qpos)
    qvel = 0.5 * d.qvel + action
    return _JaxState(_JaxData(qpos, qvel, d.qacc - qvel, d.time + 0.02),
                     state.common_step + 1), None
  return step


def _torch_step(nan_step, nan_env):
  def step(state, action):
    d = state.data
    qpos = d.qpos + action
    inject = (state.common_step >= nan_step) & (
        torch.arange(N_ENVS) == nan_env)[:, None]
    qpos = torch.where(inject, torch.nan, qpos)
    qvel = 0.5 * d.qvel + action
    return _State(_Data(qpos, qvel, d.qacc - qvel, d.time + 0.02),
                  state.common_step + 1), None
  return step


def _run_jax(out, nan_step, record_history, history):
  guard = JaxGuard(SimpleNamespace(scene=None), out_dir=str(out),
                   history=history)
  step = jax.jit(guard.wrap(_jax_step(nan_step, 2),
                            record_history=record_history))
  init, actions = _inputs()
  st = _JaxState(_JaxData(*map(jnp.asarray, init), jnp.zeros(N_ENVS)),
                 jnp.int32(0))
  for a in actions:
    st, _ = step(st, jnp.asarray(a))
  jax.block_until_ready(st.data.qpos)
  jax.effects_barrier()


def _run_torch(out, nan_step, record_history, history):
  guard = NanGuard(SimpleNamespace(scene=None), out_dir=str(out),
                   history=history)
  step = guard.wrap(_torch_step(nan_step, 2), record_history=record_history)
  init, actions = _inputs()
  st = _State(_Data(*map(torch.tensor, init),
                    torch.zeros(N_ENVS, dtype=torch.float64)),
              torch.tensor(0, dtype=torch.int32))
  for a in actions:
    st, _ = step(st, torch.tensor(a))
  return guard


def _dumps(out):
  return sorted(glob.glob(os.path.join(str(out), 'nan_dump_*.npz')))


@pytest.mark.parametrize('record_history', [False, True])
def test_guard_dumps_as_jax_on_a_fake_step(tmp_path, record_history):
  """The NaN appears at step 4 and stays; a history of 4 wraps the ring
  once. Both guards dump once, the same arrays."""
  _run_jax(tmp_path / 'jax', 4, record_history, history=4)
  guard = _run_torch(tmp_path / 'torch', 4, record_history, history=4)
  (want,), (got,) = _dumps(tmp_path / 'jax'), _dumps(tmp_path / 'torch')
  _same_arrays(_npz(got), _npz(want))
  blob = _npz(got)
  assert blob['bad_env_ids'].tolist() == [2]
  assert blob['steps'].tolist() == ([2, 3, 4, 5] if record_history else [5])
  assert np.isnan(blob['qpos'][-1]).any()
  assert guard._fired


def test_guard_dumps_nothing_when_finite(tmp_path):
  _run_jax(tmp_path / 'jax', 10 ** 9, False, history=25)
  _run_torch(tmp_path / 'torch', 10 ** 9, True, history=25)
  assert not _dumps(tmp_path / 'jax') and not _dumps(tmp_path / 'torch')


# --------------------------------------------------------------------------
# (b), (c) the forensic ring's writer and payload on stand-ins
# --------------------------------------------------------------------------

RING_N, RING_K, RING_CAP, DEC, NA, NG = 6, 4, 6, 4, 5, 7
BAD = ([], [1, 4], [0, 1, 2, 3, 5], [2, 3, 5], [0, 4])


def _ring_inputs(rng, bad):
  f32 = np.float32
  mask = np.zeros(RING_N, bool)
  mask[bad] = True
  pre = dict(time=rng.normal(size=RING_N).astype(f32),
             qpos=rng.normal(size=(RING_N, 8)).astype(f32),
             qvel=rng.normal(size=(RING_N, 7)).astype(f32),
             ctrl=rng.normal(size=(RING_N, NA)).astype(f32),
             qacc_warmstart=rng.normal(size=(RING_N, 7)).astype(f32),
             xfrc_applied=rng.normal(size=(RING_N, 3, 6)).astype(f32),
             qfrc_applied=rng.normal(size=(RING_N, 7)).astype(f32))
  return (mask, pre, rng.normal(size=(RING_N, NA)).astype(f32),
          rng.integers(0, 99, RING_N).astype(np.int32),
          rng.normal(size=(RING_N, NG, 3)).astype(f32),
          rng.normal(size=(DEC, RING_N)).astype(f32))


def _stand_ins(tmp_path):
  fields = ['geom_friction']
  common = dict(_forensic_cap=RING_CAP, _forensic_k=RING_K,
                _batched_model_fields=fields, _blowup_count=0,
                _blowup_dump_dir=None)
  jenv = SimpleNamespace(**common)
  tenv = SimpleNamespace(**common, device=torch.device('cpu'),
                         cfg=SimpleNamespace(decimation=DEC),
                         action_manager=SimpleNamespace(total_dim=NA))
  jenv._blowup_dump_dir = str(tmp_path / 'jax')
  tenv._blowup_dump_dir = str(tmp_path / 'torch')
  return jenv, tenv


@pytest.fixture
def default_float64():
  """torch's default float dtype as JAX's under x64 (the tests' JAX)."""
  before = torch.get_default_dtype()
  torch.set_default_dtype(torch.float64)
  yield
  torch.set_default_dtype(before)


def _write_both(jenv, tenv):
  """The same seeded writes into both rings; yields each ring after each
  write."""
  rng = np.random.default_rng(7)
  t = lambda x: torch.from_numpy(x)
  data = SimpleNamespace(**{k: t(v) for k, v in _ring_inputs(
      np.random.default_rng(0), [])[1].items()})
  model = SimpleNamespace(geom_friction=torch.zeros(RING_N, NG, 3,
                                                  dtype=torch.float32))
  tring = ManagerBasedRlEnv._forensic_ring(tenv, data, model)
  jring = {k: jnp.asarray(v.numpy()) for k, v in tring.items()}
  for bad in BAD:
    mask, pre, processed, ep_len, fric, peaks = _ring_inputs(rng, bad)
    jring = JaxEnv._forensic_write(
        jenv, jring, jnp.asarray(mask),
        SimpleNamespace(**{k: jnp.asarray(v) for k, v in pre.items()}),
        jnp.asarray(processed),
        SimpleNamespace(episode_length=jnp.asarray(ep_len),
                        model=SimpleNamespace(
                            geom_friction=jnp.asarray(fric))),
        jnp.asarray(peaks))
    tring = ManagerBasedRlEnv._forensic_write(
        tenv, tring, t(mask), SimpleNamespace(**{k: t(v) for k, v in
                                                 pre.items()}),
        t(processed),
        SimpleNamespace(episode_length=t(ep_len),
                        model=SimpleNamespace(geom_friction=t(fric))),
        t(peaks))
    yield bad, jring, tring


def test_forensic_write_matches_jax(tmp_path, default_float64):
  jenv, tenv = _stand_ins(tmp_path)
  total = 0
  for bad, jring, tring in _write_both(jenv, tenv):
    total += min(len(bad), RING_K)
    assert list(tring) == list(jring)
    for k, v in jring.items():
      got = tring[k].numpy()
      # the counters are int32 in both rings; JAX's sum makes them its
      # default int after a write (int64 under x64), the port's stay int32
      if k not in ('count', 'total_bad'):
        assert got.dtype == np.asarray(v).dtype, k
      np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert int(tring['count']) == total
  assert total > RING_CAP  # the ring wrapped
  # the dtypes of the JAX ring: processed_action the default float dtype
  # (float64 here, as JAX's under x64), the rest the data's (float32)
  assert tring['processed_action'].dtype == torch.float64
  assert jring['processed_action'].dtype == jnp.zeros(1).dtype
  assert tring['time'].dtype == tring['qpos'].dtype == torch.float32


def test_forensic_payload_matches_jax(tmp_path, default_float64):
  jenv, tenv = _stand_ins(tmp_path)
  for _, jring, tring in _write_both(jenv, tenv):
    pass
  jstate = SimpleNamespace(forensic=jring)
  tstate = SimpleNamespace(forensic=tring)
  jpath = tmp_path / 'jax' / 'blowup_ring.npz'
  tpath = tmp_path / 'torch' / 'blowup_ring.npz'
  count = JaxEnv.maybe_dump_forensics(jenv, jstate)
  assert ManagerBasedRlEnv.maybe_dump_forensics(tenv, tstate) == count
  _same_arrays(_npz(tpath), _npz(jpath))
  assert _npz(tpath)['qvel_peaks'].shape == (DEC, RING_CAP)

  # nothing new: neither writes again
  os.remove(jpath), os.remove(tpath)
  assert JaxEnv.maybe_dump_forensics(jenv, jstate) == count
  assert ManagerBasedRlEnv.maybe_dump_forensics(tenv, tstate) == count
  assert not jpath.exists() and not tpath.exists()

  # reset re-syncs the host count: the next dump writes again
  for cls, env, state in ((JaxEnv, jenv, jstate),
                          (ManagerBasedRlEnv, tenv, tstate)):
    env.init_state = lambda seed=None, state=state: (state, {})
    cls.reset(env)
    assert env._blowup_count == 0
    assert cls.maybe_dump_forensics(env, state) == count
  _same_arrays(_npz(tpath), _npz(jpath))


# --------------------------------------------------------------------------
# (d), (e) the G1 flat env: guard, ring, checkpoint, replay
# --------------------------------------------------------------------------


def _g1_cfg():
  cfg = registry.load_cfg(G1_FLAT_TASK, 'rl_cfg_entry_point')
  cfg.device = 'cpu'
  cfg.num_steps_per_env = 2
  cfg.policy.actor_hidden_dims = (16, 16)
  cfg.policy.critic_hidden_dims = (16,)
  return cfg


def _poisoned_run(root, ring_on: bool, monkeypatch):
  """One PPO iteration of 2 env-steps at 2 envs through a guarded step;
  before the second env-step env 1's base is spun up to SPIN about every
  axis. Returns (env, runner, what the poisoned step started from)."""
  if ring_on:
    monkeypatch.setenv('MJLAB_BLOWUP_DUMP', str(root / 'ring'))
  else:
    monkeypatch.delenv('MJLAB_BLOWUP_DUMP', raising=False)
  env = registry.make(G1_FLAT_TASK, device='cpu', **{'scene.num_envs': 2})
  seen = {}

  def poison(state, action):
    if int(state.common_step) == 1:
      qvel = state.data.qvel.clone()
      qvel[1, 3:6] = SPIN
      state = state.replace(data=state.data.replace(qvel=qvel))
      seen.update(data=state.data, state=state,
                  processed=env.action_manager.process(action))
    return env.step_fn(state, action)

  guard = NanGuard(env, out_dir=str(root / 'nan_dumps'))
  runner = OnPolicyRunner(env, _g1_cfg(), log_dir=str(root / 'run'),
                          step_fn=guard.wrap(poison))
  runner.learn(1)
  assert env.nan_guard is None  # attached only during a guarded call
  return env, runner, seen


def _same_payload(a, b, path=''):
  assert type(a) is type(b), path
  if isinstance(a, dict):
    assert list(a) == list(b), path
    for k in a:
      _same_payload(a[k], b[k], f'{path}/{k}')
  elif torch.is_tensor(a):
    assert a.dtype == b.dtype and torch.equal(a, b), path
  else:
    assert a == b, path


@pytest.fixture(scope='module')
def g1_runs(tmp_path_factory):
  root = tmp_path_factory.mktemp('g1')
  with pytest.MonkeyPatch.context() as mp:
    on = _poisoned_run(root / 'on', True, mp)
    off = _poisoned_run(root / 'off', False, mp)
  return root, on, off


def test_guard_fires_on_the_state_before_the_self_heal(g1_runs):
  """The port's guard fires under the port's env, where the JAX guard,
  which checks the state the env's step returns, never can."""
  root, (env, runner, seen), _ = g1_runs
  (dump,) = glob.glob(str(root / 'on' / 'nan_dumps' / 'nan_dump_*.npz'))
  blob = _npz(dump)
  assert blob['bad_env_ids'].tolist() == [1]
  assert blob['steps'].tolist() == [2]
  assert not np.isfinite(blob['qvel'][0, 0]).all()
  assert blob['qvel'].shape == (1, 1, 35) and blob['time'].shape == (1, 1)
  # the state the step returned was healed: the JAX guard's view
  assert bool(torch.isfinite(runner.ts.env_state.data.qvel).all())
  from mjlab_torch.physics.io import ModelArrays
  assert ModelArrays.load(str(root / 'on' / 'nan_dumps' / 'model.npz')).nq \
      == 36
  line = json.loads((root / 'on' / 'run' / 'metrics.jsonl').read_text())
  assert line['Episode_Termination/physics_nan'] == 1
  assert np.isfinite(line['loss'])


def test_ring_holds_the_pre_substep_state(g1_runs):
  root, (env, runner, seen), _ = g1_runs
  ring = _npz(root / 'on' / 'ring' / 'blowup_ring.npz')
  assert ring['env_ids'].tolist() == [1] and int(ring['n_bad_total']) == 1
  d = seen['data']
  for k in ('qpos', 'qvel', 'ctrl', 'qacc_warmstart', 'xfrc_applied',
            'qfrc_applied', 'time'):
    want = getattr(d, k)[1].numpy()
    assert ring[k][0].tobytes() == want.tobytes(), k
  assert ring['processed_action'][0].tobytes() == \
      seen['processed'][1].numpy().tobytes()
  assert ring['episode_length'][0] == int(seen['state'].episode_length[1])
  np.testing.assert_array_equal(
      ring['model_geom_friction'][0],
      seen['state'].model.geom_friction[1].numpy())
  peaks = ring['qvel_peaks'][:, 0]
  assert np.isfinite(peaks[0]) and peaks[0] > 100 and not np.isfinite(
      peaks[-1]), peaks
  # the layout of the JAX package's own ring from its round-4 G1 training
  # (its model carries the visual meshes: 69 geoms against the port's 34)
  r4 = _npz(R4_RING)
  assert list(ring) == list(r4)
  for k, v in r4.items():
    assert ring[k].dtype == v.dtype, k
    if k == 'model_geom_friction':
      assert ring[k].shape[2:] == v.shape[2:]
    elif k == 'qvel_peaks':
      assert ring[k].shape[0] == v.shape[0]
    elif v.ndim:
      assert ring[k].shape[1:] == v.shape[1:], k


def test_checkpoint_and_generator_are_the_same_with_the_ring_on_and_off(
    g1_runs):
  root, (env_on, run_on, _), (env_off, run_off, _) = g1_runs
  assert env_on._blowup_dump_dir and not env_off._blowup_dump_dir
  assert run_on.ts.env_state.forensic and not run_off.ts.env_state.forensic
  on = torch.load(root / 'on' / 'run' / 'model_1.pt', weights_only=True)
  off = torch.load(root / 'off' / 'run' / 'model_1.pt', weights_only=True)
  _same_payload(on, off)
  assert 'forensic' not in on['env_state']
  assert torch.equal(env_on.generator.get_state(),
                     env_off.generator.get_state())
  assert torch.equal(run_on.ts.gen.get_state(), run_off.ts.gen.get_state())
  # a state read back from the checkpoint gets the env's empty ring
  run_on.load(str(root / 'on' / 'run' / 'model_1.pt'), load_env_state=True)
  assert int(run_on.ts.env_state.forensic['count']) == 0


def test_replay_repeats_the_captured_peaks(g1_runs, capsys):
  root = g1_runs[0]
  batch, results = blowup_replay.main(
      [str(root / 'on' / 'ring'), '--variants', 'env-f32,eng-f32',
       '--device', 'cpu', '--num-envs', '2', '--substeps', '4'])
  assert batch['env_ids'].tolist() == [1]
  for r in results:
    assert r['peaks_err'] <= 1e-6, (r['variant'], r['peaks_err'])
    assert r['reproduced'] and len(r['substeps']) == 4
  out = capsys.readouterr().out
  assert 'env-f32    reproduced=True' in out and 'eng-f32' in out


# --------------------------------------------------------------------------
# (f) nan_viz; the training script's flag
# --------------------------------------------------------------------------


def test_nan_viz_prints_the_jax_report(tmp_path, capsys):
  _run_torch(tmp_path, 4, True, history=4)
  (dump,) = _dumps(tmp_path)
  capsys.readouterr()
  jax_nan_viz.main([dump])
  want = capsys.readouterr().out.splitlines()
  nan_viz.main([dump])
  got = capsys.readouterr().out.splitlines()
  assert got[:-1] == want[:-1] and len(want) == 6
  assert want[-1].replace('model.mjb', 'model.npz') == got[-1]


def test_train_with_the_guard_writes_no_dump_on_a_healthy_run(tmp_path):
  runner = train.main([
      G1_FLAT_TASK, '--device', 'cpu', '--log-root', str(tmp_path),
      '--env.scene.num_envs', '2', '--agent.num_steps_per_env', '2',
      '--agent.max_iterations', '1', '--agent.policy.actor_hidden_dims',
      '(16, 16)', '--agent.policy.critic_hidden_dims', '(16,)',
      '--enable-nan-guard', '--run-name', 'g'])
  run = tmp_path / 'g1_flat' / 'g'
  assert (run / 'model_1.pt').exists()
  assert not (run / 'nan_dumps').exists()
  assert runner.alg._step_fn.__name__ == 'guarded'
