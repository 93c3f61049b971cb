"""Bytes and FLOPs of an eager program, counted op by op: the port's
counterpart of XLA's compiled-module cost analysis, which an eager program
does not have.

`OpCounter(device)` is a TorchDispatchMode. For every aten op that touches
a tensor on `device` it adds
  - bytes: each tensor argument read and each tensor output written, by
    numel times itemsize. A view or alias (`view`, `expand`, `select`,
    `slice`, `t`, `as_strided`, `_unsafe_view`, ...) moves nothing and
    counts 0, and so does an allocation (`empty`). An in-place op counts
    what it reads (its destination too) and writes; `copy_`, `fill_`,
    `zero_` and the random fills count the destination as written only;
    an `out=` tensor counts as written only.
  - FLOPs: the formulas of `torch.utils.flop_counter.flop_registry` for
    the ops they cover (mm, bmm, addmm, baddbmm, ...). Any other op with a
    floating output: one FLOP an output element, or an input element for
    a reduction (sum, mean, amax, norm, ...). Ops that only move or make
    data (cat, index, gather, clone, copy_, full, ...) count 0, as XLA
    counts a concatenate, a gather or a copy.
The hand-written kernels are ctypes calls, invisible to any dispatch mode:
while a counter is active their wrappers charge it their own work
(ops/work.py, through `charge`), and the ops that compute that work are
not counted.

What the numbers are: the work of the unfused eager program, op by op. The
bytes are an upper bound on the bytes that reach HBM, since an operand
that one op wrote and the next reads from the 50 MB L2 is counted twice.
They are not the work of a fused program, so they are not the number
XLA's cost analysis gives for the JAX package's compiled step.
"""

from __future__ import annotations

import collections

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from mjlab_torch.ops import _build

# ops whose result aliases its input but whose schema does not say so
_ALIASES = frozenset({'_unsafe_view', 'lift_fresh'})
# ops that allocate without writing
_ALLOCS = frozenset({'empty', 'empty_like', 'empty_strided', 'new_empty',
                     'new_empty_strided'})
# in-place ops that overwrite their destination without reading it
_WRITE_ONLY = frozenset({'copy_', 'fill_', 'zero_', 'normal_', 'uniform_',
                         'random_', 'bernoulli_', 'exponential_'})
# ops that move, select or make data and do no arithmetic
_MOVES = frozenset({
    'cat', 'stack', 'clone', 'copy_', '_to_copy', 'index', 'index_select',
    'gather', 'scatter', 'index_put', 'index_put_', 'fill', 'fill_', 'zero_',
    'zeros', 'zeros_like', 'ones', 'ones_like', 'full', 'full_like',
    'new_zeros', 'new_ones', 'new_full', 'scalar_tensor', 'arange', 'eye',
    'repeat', 'constant_pad_nd', 'flip', 'roll', 'tril', 'triu',
    'diag_embed', 'slice_scatter', 'select_scatter', 'diagonal_scatter',
    'as_strided_scatter', 'lift_fresh_copy', 'masked_select', 'nonzero',
    '_local_scalar_dense', 'expand_copy', 'view_copy', 'unfold_copy'})
# ops whose FLOPs are one an input element
_REDUCTIONS = frozenset({
    'sum', 'mean', 'prod', 'amax', 'amin', 'max', 'min', 'aminmax',
    'norm', 'linalg_vector_norm', 'var', 'std', 'var_mean', 'std_mean',
    'logsumexp', 'nansum', 'nanmean'})


class OpCounter(TorchDispatchMode):
  """Within `with OpCounter(device) as c:` every aten op on `device` adds
  its bytes and FLOPs to `c.bytes` and `c.flops`, and each kernel wrapper
  its call's (ops/work.py). `c.ops` and `c.kernels` hold
  {name: [calls, bytes, FLOPs]} of each aten op and each kernel."""

  def __init__(self, device):
    super().__init__()
    self.device = torch.device(device)
    self.bytes = 0
    self.flops = 0
    self.ops = collections.defaultdict(lambda: [0, 0, 0])
    self.kernels = collections.defaultdict(lambda: [0, 0, 0])
    self._paused = False
    self._hook = None

  def __enter__(self):
    self._hook = _build.counting(self)
    self._hook.__enter__()
    return super().__enter__()

  def __exit__(self, *exc):
    try:
      return super().__exit__(*exc)
    finally:
      self._hook.__exit__(*exc)
      self._hook = None

  def _on_device(self, t) -> bool:
    dev = t.device
    return dev.type == self.device.type and (
        self.device.index is None or dev.index == self.device.index)

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    out = func(*args, **kwargs)
    if not self._paused:
      self._count(func, args, kwargs, out)
    return out

  def _count(self, func, args, kwargs, out) -> None:
    name = func._overloadpacket.__name__
    schema = func._schema
    written = set()  # argument names the op writes into
    for a in schema.arguments:
      if a.alias_info is not None and a.alias_info.is_write:
        written.add(a.name)
    reads = []
    for a, v in zip(schema.arguments, args):
      if a.name in written and (name in _WRITE_ONLY
                                or not name.endswith('_')):
        continue
      reads.append(v)
    for k, v in kwargs.items():
      if k not in written:
        reads.append(v)
    ins = [t for t in tree_flatten(reads)[0] if isinstance(t, torch.Tensor)
           and self._on_device(t)]
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)
            and self._on_device(t)]
    if not ins and not outs:
      return
    if func.is_view or name in _ALIASES or name in _ALLOCS:
      nbytes = 0
    else:
      nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
    flops = 0
    if func._overloadpacket in flop_registry:
      flops = int(flop_registry[func._overloadpacket](*args, **kwargs,
                                                      out_val=out))
    elif not (func.is_view or name in _MOVES or name in _ALLOCS
              or name in _ALIASES):
      floating = [t for t in outs if t.is_floating_point()]
      if floating and name in _REDUCTIONS:
        flops = max((t.numel() for t in ins if t.is_floating_point()),
                    default=0)
      elif floating:
        flops = sum(t.numel() for t in floating)
    self.bytes += nbytes
    self.flops += flops
    rec = self.ops[name]
    rec[0] += 1
    rec[1] += nbytes
    rec[2] += flops

  def charge(self, name: str, work) -> None:
    """Add one call of kernel `name`, whose (bytes, FLOPs) `work()`
    returns. The ops `work` runs are not counted, any kernel it launches
    is neither charged nor left in the launch counts."""
    launches = collections.Counter(_build.LAUNCHES)
    self._paused = True
    try:
      with _build.counting(None):
        nbytes, flops = work()
    finally:
      self._paused = False
      _build.LAUNCHES.clear()
      _build.LAUNCHES.update(launches)
    self.bytes += int(nbytes)
    self.flops += int(flops)
    rec = self.kernels[name]
    rec[0] += 1
    rec[1] += int(nbytes)
    rec[2] += int(flops)
