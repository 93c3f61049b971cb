"""Simulation configuration.

Counterpart of mjlab_tpu/sim/sim.py. `MujocoCfg` holds the solver and
integrator options. A scene composed from its cfgs takes them into its
MjSpec before the one compile (`MujocoCfg.edit_spec`, as the JAX package
does); a scene loaded as a compiled model (an MjModel or its ModelArrays
snapshot, on a host that may lack the mujoco package) takes them into the
compiled model's `opt` (`MujocoCfg.apply`). No option of MujocoCfg changes
another compiled field, so both routes give the same model
(tests/test_torch_spec_path.py holds `apply(compile(spec))` equal to
`compile(edit_spec(spec))` field by field). `MujocoCfg.check_model` holds a
model compiled elsewhere to the configuration and raises on a mismatch.
`expand_model_fields` gives selected model fields a leading env axis for
per-env domain randomization. `make_batched_data` is physics.io's.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Literal

import numpy as np

from mjlab_torch.physics.io import ModelArrays
from mjlab_torch.physics.io import make_batched_data  # noqa: F401
from mjlab_torch.physics.types import ConeType, IntegratorType, Model

_CONE = {'pyramidal': ConeType.PYRAMIDAL, 'elliptic': ConeType.ELLIPTIC}
_INTEGRATOR = {'euler': IntegratorType.EULER,
               'implicitfast': IntegratorType.IMPLICITFAST}

# Model fields the engine reads with a leading env axis: every field that
# domain randomization may name (the keys of envs/mdp/events.py:
# FIELD_SPECS). Each stage reads its env's row of an expanded field and the
# one row of a shared one; the fused smooth stage's kernel (K3) takes the
# segments of its float table per env where the Model carries them so. The
# Newton solve (K2) reads no model table but `ldof`, a joint-limit index
# list that no field here changes. Derived fields (body_subtreemass, the
# *_invweight0) stay as compiled, as in the reference.
PER_ENV_FIELDS = (
    'dof_armature', 'dof_frictionloss', 'dof_damping', 'jnt_range',
    'jnt_stiffness', 'body_mass', 'body_ipos', 'body_iquat', 'body_inertia',
    'body_pos', 'body_quat', 'geom_friction', 'geom_pos', 'geom_quat',
    'geom_rgba', 'site_pos', 'site_quat', 'qpos0')


@dataclasses.dataclass
class MujocoCfg:
  """Solver and integrator options of the compiled model."""
  timestep: float = 0.002
  integrator: Literal['euler', 'implicitfast'] = 'implicitfast'
  impratio: float = 1.0
  cone: Literal['pyramidal', 'elliptic'] = 'pyramidal'
  iterations: int = 10
  tolerance: float = 1e-8
  ls_iterations: int = 20
  ls_tolerance: float = 0.01
  gravity: tuple = (0.0, 0.0, -9.81)

  def options(self) -> dict:
    """The compiled `opt` fields this cfg sets, by name."""
    return dict(
        timestep=self.timestep, integrator=int(_INTEGRATOR[self.integrator]),
        impratio=self.impratio, cone=int(_CONE[self.cone]),
        iterations=self.iterations, tolerance=self.tolerance,
        ls_iterations=self.ls_iterations, ls_tolerance=self.ls_tolerance,
        gravity=self.gravity)

  def edit_spec(self, spec) -> None:
    """Write the options into an MjSpec's `option` (needs mujoco)."""
    import mujoco
    opt = spec.option
    opt.timestep = self.timestep
    opt.integrator = {'euler': mujoco.mjtIntegrator.mjINT_EULER,
                      'implicitfast': mujoco.mjtIntegrator.mjINT_IMPLICITFAST
                      }[self.integrator]
    opt.cone = {'pyramidal': mujoco.mjtCone.mjCONE_PYRAMIDAL,
                'elliptic': mujoco.mjtCone.mjCONE_ELLIPTIC}[self.cone]
    opt.impratio = self.impratio
    opt.iterations = self.iterations
    opt.tolerance = self.tolerance
    opt.ls_iterations = self.ls_iterations
    opt.ls_tolerance = self.ls_tolerance
    opt.gravity = self.gravity

  def apply(self, mj_model):
    """A copy of the compiled model (a ModelArrays snapshot or an MjModel)
    with this cfg's options in its `opt`."""
    if isinstance(mj_model, ModelArrays):
      a = mj_model.arrays()
      for k, v in self.options().items():
        old = np.asarray(a[f'opt.{k}'])
        a[f'opt.{k}'] = np.asarray(v, old.dtype).reshape(old.shape)
      return ModelArrays(a)
    out = copy.copy(mj_model)
    for k, v in self.options().items():
      setattr(out.opt, k, v)
    return out

  def check_model(self, mj_model) -> None:
    """Raise unless the compiled model's options equal this cfg."""
    opt = mj_model.opt
    want = self.options()
    wrong = {k: (np.asarray(getattr(opt, k)).tolist(), v)
             for k, v in want.items()
             if not np.array_equal(np.asarray(getattr(opt, k), np.float64),
                                   np.asarray(v, np.float64))}
    if wrong:
      raise ValueError(
          'the compiled model was built with other options than the '
          'configuration asks for (compiled, configured): ' + ', '.join(
              f'{k}: {got} != {cfg}' for k, (got, cfg) in wrong.items()))


@dataclasses.dataclass
class SimulationCfg:
  """nconmax is the per-env active-contact capacity (see
  physics.io.put_model); None = auto."""
  nconmax: 'int | None' = None
  mujoco: MujocoCfg = dataclasses.field(default_factory=MujocoCfg)


def expand_model_fields(model: Model, fields: 'list[str]',
                        num_envs: int) -> Model:
  """Give the selected model fields a leading env axis (a fresh tensor per
  field), so per-env domain randomization can write them. A field outside
  PER_ENV_FIELDS raises: the engine would read it as shared."""
  updates = {}
  for f in sorted(set(fields)):
    if f not in PER_ENV_FIELDS:
      raise NotImplementedError(
          f'per-env model field {f!r} is not supported by mjlab_torch '
          f'(ROADMAP 12.11; supported: {list(PER_ENV_FIELDS)})')
    leaf = getattr(model, f)
    updates[f] = leaf.expand((num_envs,) + leaf.shape).clone()
  return model.replace(**updates)
