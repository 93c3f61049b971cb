"""Policy deployment export: ONNX with the metadata a robot needs.

Counterpart of mjlab_tpu/rl/exporter.py for the port's `ActorCritic` and
`RunningNorm`. The actor's layers go through the framework's own protobuf
writer (rl/onnx_writer.py) as obs -> Sub(obs_mean) -> Div(obs_std) ->
[Gemm -> activation]* -> Gemm, with `nn.Linear.weight` (out, in) written
transposed, as the (in, out) kernel `Gemm transB=0` wants. The metadata
(joint names, stiffness, damping, default pose, action scale and offset)
goes into the graph's metadata_props and into a `<path>.meta.json`
sidecar.

The normalizer is folded into the graph only where the policy uses it:
with `normalize_obs` (the runner cfg's `actor_obs_normalization`) the
graph gets its `mean` and `sqrt(var) + 1e-2`; without it `obs_mean = 0`
and `obs_std = 1`, so the graph keeps the reference's node list and
computes what the policy computes. The reference folds the running
statistics in either way, which the learner updates whether or not the
policy normalizes: its graph of a policy trained without normalization is
not that policy. The port does not carry that over.

The tracking task's export (`export_motion_policy_as_onnx`) bakes the
motion clip into the graph: an int64 `time_step` input, clipped to the
clip, gathers the joint targets and the anchor pose of that frame.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from mjlab_torch.rl import onnx_writer


def _mlp_layers(mlp) -> 'list[tuple[np.ndarray, np.ndarray]]':
  """[(kernel (in, out), bias), ...] of an rl/networks.py MLP, float32."""
  out = []
  for layer in mlp.layers:
    w = layer.weight.detach().to('cpu', torch.float32).numpy()
    b = layer.bias.detach().to('cpu', torch.float32).numpy()
    out.append((np.ascontiguousarray(w.T), b))
  return out


def _numpy(x) -> np.ndarray:
  return (x.detach().cpu().numpy() if torch.is_tensor(x)
          else np.asarray(x))


def policy_metadata(env, action_term: str = 'joint_pos') -> dict:
  """The env's action term's joints and scale, and the robot's stiffness,
  damping and default pose at those joints."""
  term = env.action_manager.terms[action_term]
  view, ids = term.view, _numpy(term.joint_ids)
  return {
      'joint_names': list(term.joint_names),
      'joint_stiffness': _numpy(view.joint_stiffness)[ids].tolist(),
      'joint_damping': _numpy(view.joint_damping)[ids].tolist(),
      'default_joint_pos': _numpy(view.default_joint_pos)[ids].tolist(),
      'action_scale': _numpy(term.scale).tolist(),
      'action_offset': _numpy(term.offset).tolist(),
  }


def _gather_metadata(env, metadata) -> dict:
  """`metadata` and the env's policy metadata. As in the reference, an env
  without them (no action manager, or no joint action term) records why
  under 'metadata_error' and the export goes on."""
  meta = dict(metadata or {})
  if env is not None:
    try:
      meta.update(policy_metadata(env))
    except (AttributeError, KeyError) as e:
      meta['metadata_error'] = repr(e)
  return meta


def _write_sidecar(path: str, meta: dict) -> None:
  with open(path + '.meta.json', 'w') as f:
    json.dump(meta, f, indent=2)


def _normalizer(normalizer, dim: int, normalize_obs: bool):
  """(mean, std) the graph folds in: the running statistics' `mean` and
  `sqrt(var) + 1e-2` where the policy normalizes, else the identity."""
  if normalize_obs:
    mean = _numpy(normalizer.mean).astype(np.float32)
    std = (np.sqrt(_numpy(normalizer.var)) + 1e-2).astype(np.float32)
    return mean, std
  return np.zeros(dim, np.float32), np.ones(dim, np.float32)


def export_policy_as_onnx(net, normalizer, env, path: str,
                          normalize_obs: bool, activation: str = 'elu',
                          metadata: 'dict | None' = None) -> str:
  """Write the actor of `net` (an ActorCritic, or anything with an `actor`
  MLP) as ONNX, input `obs` (batch, obs_dim) -> `actions`, with
  `normalizer` (a RunningNorm) folded in where `normalize_obs`; the env's
  policy metadata and `metadata` go into the graph and the sidecar."""
  layers = _mlp_layers(net.actor)
  mean, std = _normalizer(normalizer, layers[0][0].shape[0], normalize_obs)
  meta = _gather_metadata(env, metadata)
  onnx_writer.write_mlp_policy(path, layers, mean, std, activation, meta)
  _write_sidecar(path, meta)
  return path


def export_motion_policy_as_onnx(net, normalizer, env, motion, path: str,
                                 normalize_obs: bool,
                                 activation: str = 'elu',
                                 metadata: 'dict | None' = None) -> str:
  """The tracking task's export: the actor as in export_policy_as_onnx,
  and the clip of `motion` (a MotionLoader) baked in. Inputs `obs` and
  `time_step` (int64); outputs `actions` and the frame's `joint_pos`,
  `joint_vel`, `anchor_pos_w` and `anchor_quat_w` (body 0 of the clip's
  tracked bodies)."""
  layers = _mlp_layers(net.actor)
  mean, std = _normalizer(normalizer, layers[0][0].shape[0], normalize_obs)
  motion_arrays = {
      'joint_pos': np.asarray(motion.joint_pos, np.float32),
      'joint_vel': np.asarray(motion.joint_vel, np.float32),
      'anchor_pos_w': np.asarray(motion.body_pos_w[:, 0], np.float32),
      'anchor_quat_w': np.asarray(motion.body_quat_w[:, 0], np.float32),
  }
  meta = _gather_metadata(env, metadata)
  onnx_writer.write_motion_policy(path, layers, mean, std, motion_arrays,
                                  activation, meta)
  _write_sidecar(path, meta)
  return path
