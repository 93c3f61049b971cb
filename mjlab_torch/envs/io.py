"""Carry an environment's state across as numpy leaves.

`env_state_to_numpy` turns an EnvState into a nested dict of numpy arrays;
`env_state_from_numpy` builds an EnvState of a given env from such a dict,
which may as well hold the leaves of another holder of the same state (the
JAX package's EnvState), so that two envs can be put into the same state.

Layout: 'data' (physics.io.data_from_numpy's dict), 'model' (the per-env
model fields only), 'episode_length', 'common_step', 'actions',
'prev_actions', 'reward_sums', and the manager state dicts 'command',
'obs', 'event', 'curriculum', 'reward' (nested dicts of arrays; a circular
buffer is a dict of its fields). The forensic ring of MJLAB_BLOWUP_DUMP is
a debugging aid and is not carried: a state built here gets the env's
empty ring.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mjlab_torch.envs.types import EnvState
from mjlab_torch.physics.io import CONTACT_FIELDS, DATA_FIELDS, data_from_numpy

_LEAVES = ('episode_length', 'common_step', 'actions', 'prev_actions',
           'reward_sums', 'command', 'obs', 'event', 'curriculum', 'reward')


def _to_numpy(x):
  if torch.is_tensor(x):
    return x.detach().cpu().numpy()
  if dataclasses.is_dataclass(x):
    return {f.name: _to_numpy(getattr(x, f.name))
            for f in dataclasses.fields(x)}
  if isinstance(x, dict):
    return {k: _to_numpy(v) for k, v in x.items()}
  return x


def _like(template, x):
  """`x` (numpy leaves) in the structure, dtypes and on the device of
  `template`; floating leaves take the template's floating dtype."""
  if torch.is_tensor(template):
    return torch.tensor(np.asarray(x), device=template.device).to(
        template.dtype).reshape(template.shape)
  if dataclasses.is_dataclass(template):
    return dataclasses.replace(template, **{
        f.name: _like(getattr(template, f.name), x[f.name])
        for f in dataclasses.fields(template)})
  if isinstance(template, dict):
    return {k: _like(v, x[k]) for k, v in template.items()}
  return template


def env_state_to_numpy(state: EnvState, env) -> dict:
  """The leaves of `state`, a state of `env`, as numpy arrays."""
  d = state.data
  data = {k: _to_numpy(getattr(d, k)) for k in DATA_FIELDS}
  data['contact'] = {k: _to_numpy(getattr(d.contact, k))
                     for k in CONTACT_FIELDS}
  out = {k: _to_numpy(getattr(state, k)) for k in _LEAVES}
  out['data'] = data
  out['model'] = {k: _to_numpy(getattr(state.model, k))
                  for k in env.per_env_fields}
  return out


def env_state_from_numpy(arrays: dict, env) -> EnvState:
  """The state of `env` (a ManagerBasedRlEnv) holding `arrays`. Structure,
  dtypes and device are those of the env's own template state; tensors are
  fresh, so the result shares no memory with the template."""
  template = env._template_state
  model = template.model.replace(**{
      k: _like(getattr(template.model, k), v)
      for k, v in arrays.get('model', {}).items()})
  return EnvState(
      model=model, data=data_from_numpy(arrays['data'], model),
      forensic={k: v.clone() for k, v in template.forensic.items()},
      **{k: _like(getattr(template, k), arrays[k]) for k in _LEAVES})
