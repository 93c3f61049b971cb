"""Minimal ONNX serializer and decoder that needs only numpy.

The port's own copy of mjlab_tpu/rl/onnx_writer.py, byte for byte in what
it writes (tests/data/golden_policy.onnx pins the serialization; the
producer name stays the reference's, so one policy exported by either
package gives one file). Neither host ships the `onnx` package, so the
framework carries its own protobuf encoder for the small class of graphs
it exports: normalized-MLP policies (Sub -> Div -> [Gemm -> activation]*
-> Gemm) and the tracking variant with baked motion tensors gathered by a
time_step input.

Wire format follows onnx.proto3 (IR version 8, default opset 17):
ModelProto{1:ir_version, 2:producer, 7:graph, 8:opset_import,
14:metadata_props}; GraphProto{1:node, 2:name, 5:initializer, 11:input,
12:output}; NodeProto{1:input, 2:output, 3:name, 4:op_type, 5:attribute};
AttributeProto{1:name, 2:f, 3:i, 4:s, 5:t, 7:floats, 8:ints, 20:type};
TensorProto{1:dims, 2:data_type, 8:name, 9:raw_data};
ValueInfoProto{1:name, 2:type{1:tensor_type{1:elem_type, 2:shape{1:dim{
1:dim_value}}}}}; StringStringEntryProto{1:key, 2:value};
OperatorSetIdProto{1:domain, 2:version}.

A matching minimal decoder (`parse_model`) reads the graph back, and
`run_mlp_policy` and `run_motion_policy` evaluate an exported policy graph
in numpy.
"""

from __future__ import annotations

import json
import struct as _struct

import numpy as np

FLOAT = 1
INT64 = 7

_ATTR_FLOAT = 1
_ATTR_INT = 2
_ATTR_STRING = 3
_ATTR_TENSOR = 4
_ATTR_FLOATS = 6
_ATTR_INTS = 7


# ---------------------------------------------------------------------------
# protobuf primitives
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
  out = bytearray()
  n &= (1 << 64) - 1
  while True:
    b = n & 0x7F
    n >>= 7
    if n:
      out.append(b | 0x80)
    else:
      out.append(b)
      return bytes(out)


def _tag(field: int, wire: int) -> bytes:
  return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
  return _tag(field, 2) + _varint(len(payload)) + payload


def _string(field: int, s: str) -> bytes:
  return _len_delim(field, s.encode())


def _int_field(field: int, v: int) -> bytes:
  return _tag(field, 0) + _varint(v)


def _float_field(field: int, v: float) -> bytes:
  return _tag(field, 5) + _struct.pack('<f', v)


# ---------------------------------------------------------------------------
# ONNX messages
# ---------------------------------------------------------------------------


def _np_dtype(arr: np.ndarray) -> int:
  if arr.dtype == np.float32:
    return FLOAT
  if arr.dtype == np.int64:
    return INT64
  raise ValueError(f'unsupported dtype {arr.dtype}')


def tensor(name: str, arr: np.ndarray) -> bytes:
  arr = np.ascontiguousarray(arr)
  out = b''
  for d in arr.shape:
    out += _int_field(1, d)
  out += _int_field(2, _np_dtype(arr))
  out += _string(8, name)
  out += _len_delim(9, arr.tobytes())  # raw_data, little-endian
  return out


def _attribute(name: str, value) -> bytes:
  out = _string(1, name)
  if isinstance(value, float):
    out += _float_field(2, value) + _int_field(20, _ATTR_FLOAT)
  elif isinstance(value, int):
    out += _int_field(3, value) + _int_field(20, _ATTR_INT)
  elif isinstance(value, str):
    out += _len_delim(4, value.encode()) + _int_field(20, _ATTR_STRING)
  elif isinstance(value, bytes):
    out += _len_delim(4, value) + _int_field(20, _ATTR_STRING)
  elif isinstance(value, np.ndarray):
    out += _len_delim(5, tensor(name + '_t', value))
    out += _int_field(20, _ATTR_TENSOR)
  elif isinstance(value, (list, tuple)) and value and \
      isinstance(value[0], float):
    for v in value:
      out += _float_field(7, v)
    out += _int_field(20, _ATTR_FLOATS)
  elif isinstance(value, (list, tuple)):
    for v in value:
      out += _int_field(8, int(v))
    out += _int_field(20, _ATTR_INTS)
  else:
    raise ValueError(f'unsupported attribute {name}={value!r}')
  return out


def node(op_type: str, inputs, outputs, name: str = '', **attrs) -> bytes:
  out = b''
  for i in inputs:
    out += _string(1, i)
  for o in outputs:
    out += _string(2, o)
  out += _string(3, name or f'{op_type}_{outputs[0]}')
  out += _string(4, op_type)
  for k, v in attrs.items():
    out += _len_delim(5, _attribute(k, v))
  return out


def value_info(name: str, elem_type: int, shape) -> bytes:
  dims = b''
  for d in shape:
    if isinstance(d, str):
      dims += _len_delim(1, _string(2, d))  # dim_param
    else:
      dims += _len_delim(1, _int_field(1, int(d)))  # dim_value
  tensor_type = _int_field(1, elem_type) + _len_delim(2, dims)
  typ = _len_delim(1, tensor_type)
  return _string(1, name) + _len_delim(2, typ)


def graph(nodes, name, inputs, outputs, initializers) -> bytes:
  out = b''
  for n in nodes:
    out += _len_delim(1, n)
  out += _string(2, name)
  for t in initializers:
    out += _len_delim(5, t)
  for vi in inputs:
    out += _len_delim(11, vi)
  for vi in outputs:
    out += _len_delim(12, vi)
  return out


def model(graph_bytes: bytes, metadata: 'dict | None' = None,
          opset: int = 17, producer: str = 'mjlab_tpu') -> bytes:
  out = _int_field(1, 8)  # ir_version 8
  out += _string(2, producer)
  out += _len_delim(7, graph_bytes)
  out += _len_delim(8, _string(1, '') + _int_field(2, opset))
  for k, v in (metadata or {}).items():
    entry = _string(1, str(k)) + _string(2, v if isinstance(v, str)
                                         else json.dumps(v))
    out += _len_delim(14, entry)
  return out


# ---------------------------------------------------------------------------
# Graph builders
# ---------------------------------------------------------------------------


_ACT_OP = {'elu': 'Elu', 'relu': 'Relu', 'tanh': 'Tanh',
           'silu': 'Sigmoid'}  # silu lowered as x*sigmoid(x) below


def mlp_policy_graph(layers, obs_mean: np.ndarray, obs_std: np.ndarray,
                     activation: str = 'elu',
                     obs_name: str = 'obs', out_name: str = 'actions',
                     prefix: str = '') -> tuple:
  """(nodes, initializers, obs_dim, out_dim) for a normalized MLP:
  out = W_n(act(...act(W_0 @ norm(obs) + b_0)...)) + b_n."""
  nodes = []
  inits = [tensor(prefix + 'obs_mean', obs_mean.astype(np.float32)),
           tensor(prefix + 'obs_std', obs_std.astype(np.float32))]
  nodes.append(node('Sub', [obs_name, prefix + 'obs_mean'],
                    [prefix + 'obs_centered']))
  nodes.append(node('Div', [prefix + 'obs_centered', prefix + 'obs_std'],
                    [prefix + 'h0']))
  cur = prefix + 'h0'
  for i, (w, b) in enumerate(layers):
    wn, bn = f'{prefix}w{i}', f'{prefix}b{i}'
    inits.append(tensor(wn, np.asarray(w, np.float32)))  # (in, out)
    inits.append(tensor(bn, np.asarray(b, np.float32)))
    gemm_out = (f'{prefix}g{i}' if i < len(layers) - 1 else out_name)
    nodes.append(node('Gemm', [cur, wn, bn], [gemm_out],
                      alpha=1.0, beta=1.0, transB=0))
    cur = gemm_out
    if i < len(layers) - 1:
      act_out = f'{prefix}a{i}'
      if activation == 'silu':
        nodes.append(node('Sigmoid', [cur], [f'{prefix}sig{i}']))
        nodes.append(node('Mul', [cur, f'{prefix}sig{i}'], [act_out]))
      elif activation == 'gelu':
        nodes.append(node('Gelu', [cur], [act_out]))
      else:
        nodes.append(node(_ACT_OP[activation], [cur], [act_out]))
      cur = act_out
  return nodes, inits, layers[0][0].shape[0], layers[-1][0].shape[1]


def write_mlp_policy(path: str, layers, obs_mean, obs_std,
                     activation: str = 'elu',
                     metadata: 'dict | None' = None) -> str:
  nodes, inits, obs_dim, out_dim = mlp_policy_graph(
      layers, obs_mean, obs_std, activation)
  g = graph(nodes, 'policy',
            inputs=[value_info('obs', FLOAT, ['batch', obs_dim])],
            outputs=[value_info('actions', FLOAT, ['batch', out_dim])],
            initializers=inits)
  blob = model(g, metadata)
  with open(path, 'wb') as f:
    f.write(blob)
  return path


def write_motion_policy(path: str, layers, obs_mean, obs_std, motion_arrays,
                        activation: str = 'elu',
                        metadata: 'dict | None' = None) -> str:
  """Tracking export: motion tensors baked as initializers, gathered by an
  int64 `time_step` input clipped to the motion length."""
  nodes, inits, obs_dim, out_dim = mlp_policy_graph(
      layers, obs_mean, obs_std, activation)
  first = next(iter(motion_arrays.values()))
  t_total = int(np.asarray(first).shape[0])
  inits.append(tensor('ts_min', np.asarray(0, np.int64).reshape(())))
  inits.append(tensor('ts_max', np.asarray(t_total - 1,
                                           np.int64).reshape(())))
  nodes.append(node('Clip', ['time_step', 'ts_min', 'ts_max'],
                    ['time_step_c']))
  outputs = [value_info('actions', FLOAT, ['batch', out_dim])]
  for name, arr in motion_arrays.items():
    arr = np.asarray(arr, np.float32)
    inits.append(tensor(f'motion_{name}', arr))
    nodes.append(node('Gather', [f'motion_{name}', 'time_step_c'], [name],
                      axis=0))
    outputs.append(value_info(name, FLOAT,
                              ['batch'] + list(arr.shape[1:])))
  g = graph(nodes, 'motion_policy',
            inputs=[value_info('obs', FLOAT, ['batch', obs_dim]),
                    value_info('time_step', INT64, ['batch'])],
            outputs=outputs, initializers=inits)
  meta = dict(metadata or {})
  meta['motion_frames'] = t_total
  blob = model(g, meta)
  with open(path, 'wb') as f:
    f.write(blob)
  return path


# ---------------------------------------------------------------------------
# Minimal decoder (round-trip tests)
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int) -> tuple:
  n = 0
  shift = 0
  while True:
    b = buf[i]
    i += 1
    n |= (b & 0x7F) << shift
    if not b & 0x80:
      return n, i
    shift += 7


def _fields(buf: bytes):
  i = 0
  while i < len(buf):
    key, i = _read_varint(buf, i)
    field, wire = key >> 3, key & 7
    if wire == 0:
      v, i = _read_varint(buf, i)
    elif wire == 2:
      ln, i = _read_varint(buf, i)
      v = buf[i:i + ln]
      i += ln
    elif wire == 5:
      v = buf[i:i + 4]
      i += 4
    else:
      raise ValueError(f'wire type {wire} unsupported')
    yield field, wire, v


def parse_model(path: str) -> dict:
  """Structural parse: graph nodes (op_type, inputs, outputs), initializer
  tensors {name: array}, io names, metadata."""
  with open(path, 'rb') as f:
    buf = f.read()
  out = {'nodes': [], 'initializers': {}, 'inputs': [], 'outputs': [],
         'metadata': {}}
  graph_buf = None
  for field, _, v in _fields(buf):
    if field == 7:
      graph_buf = v
    elif field == 14:
      kv = dict(_parse_ss(v))
      out['metadata'][kv['key']] = kv['value']
  for field, _, v in _fields(graph_buf):
    if field == 1:
      n = {'op_type': '', 'inputs': [], 'outputs': []}
      for f2, _, v2 in _fields(v):
        if f2 == 1:
          n['inputs'].append(v2.decode())
        elif f2 == 2:
          n['outputs'].append(v2.decode())
        elif f2 == 4:
          n['op_type'] = v2.decode()
      out['nodes'].append(n)
    elif field == 5:
      name, arr = _parse_tensor(v)
      out['initializers'][name] = arr
    elif field == 11:
      out['inputs'].append(_vi_name(v))
    elif field == 12:
      out['outputs'].append(_vi_name(v))
  return out


def _parse_ss(buf):
  for f, _, v in _fields(buf):
    yield ('key' if f == 1 else 'value'), v.decode()


def _vi_name(buf):
  for f, _, v in _fields(buf):
    if f == 1:
      return v.decode()
  return ''


def _parse_tensor(buf):
  dims, dtype, name, raw = [], FLOAT, '', b''
  for f, w, v in _fields(buf):
    if f == 1:
      dims.append(v)
    elif f == 2:
      dtype = v
    elif f == 8:
      name = v.decode()
    elif f == 9:
      raw = v
  np_dtype = {FLOAT: np.float32, INT64: np.int64}[dtype]
  arr = np.frombuffer(raw, np_dtype).reshape(dims)
  return name, arr


# ---------------------------------------------------------------------------
# Evaluation in numpy (checks of an exported policy)
# ---------------------------------------------------------------------------


def _elu(x):
  return np.where(x > 0, x, np.expm1(np.minimum(x, 0))).astype(x.dtype)


def _gelu(x):
  import math
  erf = np.vectorize(math.erf, otypes=[np.float64])
  return (0.5 * x * (1.0 + erf(x / math.sqrt(2.0)))).astype(x.dtype)


_NUMPY_OPS = {
    'Sub': lambda a, b: a - b,
    'Div': lambda a, b: a / b,
    'Mul': lambda a, b: a * b,
    'Gemm': lambda x, w, b: x @ w + b,  # alpha = beta = 1, transB = 0
    'Elu': _elu,  # alpha = 1
    'Relu': lambda x: np.maximum(x, 0),
    'Tanh': np.tanh,
    'Sigmoid': lambda x: 1 / (1 + np.exp(-x)),
    'Gelu': _gelu,
    'Clip': np.clip,  # min and max are inputs, as in opset 11+
    'Gather': lambda data, idx: np.take(data, idx, axis=0),  # axis = 0
}


def _run(parsed: dict, inputs: dict) -> dict:
  """Every value of the graph, its inputs given."""
  vals = dict(parsed['initializers'])
  vals.update(inputs)
  for n in parsed['nodes']:
    op = _NUMPY_OPS.get(n['op_type'])
    if op is None:
      raise NotImplementedError(f'op {n["op_type"]} in a policy graph')
    vals[n['outputs'][0]] = op(*(vals[i] for i in n['inputs']))
  return vals


def run_mlp_policy(parsed: dict, obs: np.ndarray) -> np.ndarray:
  """The first output of a policy graph that `mlp_policy_graph` built, as
  `parse_model` returns it, evaluated in float32 numpy on `obs` (batch,
  obs_dim), with the attributes this writer gives its nodes."""
  vals = _run(parsed, {parsed['inputs'][0]: np.asarray(obs, np.float32)})
  return vals[parsed['outputs'][0]]


def run_motion_policy(parsed: dict, obs: np.ndarray,
                      time_step: np.ndarray) -> dict:
  """Every output of a graph that `write_motion_policy` wrote, by name,
  evaluated in numpy on `obs` (batch, obs_dim) and `time_step` (batch,),
  int64: the actions, and the clip's frames at `time_step` clipped to the
  clip (`Clip`, then `Gather` on axis 0)."""
  vals = _run(parsed, {'obs': np.asarray(obs, np.float32),
                       'time_step': np.asarray(time_step, np.int64)})
  return {name: vals[name] for name in parsed['outputs']}
