"""Multi-GPU training: the env axis split over the ranks of a process group.

Counterpart of mjlab_tpu/parallel/sharding.py. There GSPMD shards the env
axis of the state over a device mesh and turns every reduction over it into
a collective. Here each rank is a process that steps an env of its own,
rows [offset, offset + n_local) of the global env of `num_envs` envs, on its
own card, and holds the whole learner; every reduction over the env axis is
written out with the helpers below: `all_reduce_flat` (the learner's
gradients and losses, the normalizers' moments, the logs, the env's refresh
flag, the tracking command's bin failures), `gather_env` (a checkpoint's env
state), `broadcast_` (the learner, from rank 0) and `broadcast_object` (the
run directory, a loaded checkpoint's learner).

Backend: NCCL when each rank has a card of its own (the ranks trade their
cards' UUIDs at the rendezvous); gloo on the CPU and when ranks share a
card, which NCCL refuses. Under gloo a CUDA tensor goes through the host
for every collective.

A `World` of one without a process group is one process that holds every
env: the code paths of an unsharded run (`World.sharded` is false).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch

# The roots of a learner's tree (the JAX package's names and the port's
# checkpoint keys) that hold per-model or per-run leaves, never per-env
# ones: a leaf under one of them is never sliced or gathered, whatever its
# shape, so that a (num_envs, h) weight is not taken for the env axis. As in
# the JAX package, they are matched at the root of the tree only. Env state
# that every rank holds alike is named by the terms that keep it
# (`replicated_state`, ManagerBasedRlEnv.replicated_state) and handed to
# the functions below as `replicated_paths`.
REPLICATED_SUBTREES = frozenset(
    {'params', 'opt_state', 'actor_norm', 'critic_norm', 'lr', 'iteration',
     'rng', 'adam', 'gen', 'env_gen'})


def assert_divisible(num_envs: int, world_size: int) -> None:
  if num_envs % world_size:
    raise ValueError(
        f'num_envs={num_envs} not divisible by the world size {world_size}')


@dataclasses.dataclass(frozen=True)
class World:
  """Where this process stands: its rank of `size`, its card and the
  process group (None: no torch.distributed). `num_envs` is the global env
  count; the rank steps `n_local` of them from `offset`. `local_rank` is
  the rank among the processes of its host."""
  num_envs: int
  device: torch.device
  rank: int = 0
  size: int = 1
  group: Any = None
  backend: 'str | None' = None
  local_rank: int = 0

  def __post_init__(self):
    assert_divisible(self.num_envs, self.size)

  @property
  def sharded(self) -> bool:
    """Whether this process runs the sharded code paths: its envs are a
    part of a global env, or it belongs to a process group. A group of one
    stays sharded: `--shard` on one card runs every collective of a W-rank
    run, each then an identity, so that one card exercises them and times
    what they cost. A World of several ranks without a group lays out a
    rank's rows in one process (the tests build one so); a collective over
    it raises."""
    return self.group is not None or self.size > 1

  @property
  def n_local(self) -> int:
    return self.num_envs // self.size

  @property
  def offset(self) -> int:
    return self.rank * self.n_local

  @property
  def rows(self) -> slice:
    return slice(self.offset, self.offset + self.n_local)

  @property
  def is_main(self) -> bool:
    return self.rank == 0

  def barrier(self) -> None:
    if not _communicates(self):
      return
    import torch.distributed as dist
    if self.backend == 'nccl':
      dist.barrier(self.group, device_ids=[self.device.index])
    else:
      dist.barrier(self.group)


def rank_device(device, local_rank: int) -> torch.device:
  """The card of local rank `local_rank` (ranks beyond the visible cards
  share them in turn), or the CPU."""
  device = torch.device(device)
  if device.type != 'cuda':
    return device
  if not torch.cuda.is_available():
    raise RuntimeError('CUDA is not available: pass device="cpu" to run '
                       'on the CPU')
  return torch.device('cuda', local_rank % torch.cuda.device_count())


def card_key(device) -> str:
  """What tells this process's card from every other card of the world:
  its host and the card's UUID. Two ranks whose keys are equal share one
  card, whatever the indices their own CUDA_VISIBLE_DEVICES gives it."""
  import socket
  device = torch.device(device)
  if device.type != 'cuda':
    return f'{socket.gethostname()}/{device.type}'
  return (f'{socket.gethostname()}/'
          f'{torch.cuda.get_device_properties(device).uuid}')


def backend_for(device, card_keys: 'list[str]') -> str:
  """NCCL when the ranks are on cards (`card_keys`, every rank's
  card_key) and no two share one, else gloo (the CPU; ranks sharing a
  card, which NCCL refuses)."""
  if torch.device(device).type != 'cuda':
    return 'gloo'
  return 'nccl' if len(set(card_keys)) == len(card_keys) else 'gloo'


def init_world(num_envs: int, device='cuda', rank: 'int | None' = None,
               size: 'int | None' = None, local_rank: 'int | None' = None,
               init_method: str = 'env://',
               timeout_s: float = 600.0) -> World:
  """Start this process's process group and return its World. Unset
  arguments come from a launcher's environment (`torch.distributed.run`
  sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT); a world
  of one without a launcher needs no address. The ranks meet at the
  rendezvous first and trade their card_keys there, which choose the
  backend. A failed start raises: nothing falls back to a world of one."""
  import torch.distributed as dist
  env = os.environ
  rank = int(env.get('RANK', 0)) if rank is None else rank
  size = int(env.get('WORLD_SIZE', 1)) if size is None else size
  local_rank = (int(env.get('LOCAL_RANK', rank)) if local_rank is None
                else local_rank)
  assert_divisible(num_envs, size)
  dev = rank_device(device, local_rank)
  if dev.type == 'cuda':
    torch.cuda.set_device(dev)
  timeout = datetime.timedelta(seconds=timeout_s)
  if size == 1 and 'MASTER_ADDR' not in env and init_method == 'env://':
    store = dist.HashStore()
  else:
    store, rank, size = next(dist.rendezvous(init_method, rank, size,
                                             timeout=timeout))
    store.set_timeout(timeout)
  store.set(f'mjlab_card/{rank}', card_key(dev))
  keys = [store.get(f'mjlab_card/{r}').decode() for r in range(size)]
  backend = backend_for(dev, keys)
  kw = dict(backend=backend, rank=rank, world_size=size, timeout=timeout,
            store=dist.PrefixStore('default_pg', store))
  if backend == 'nccl':
    kw['device_id'] = dev
  dist.init_process_group(**kw)
  return World(num_envs=num_envs, device=dev, rank=rank, size=size,
               group=dist.group.WORLD, backend=backend,
               local_rank=local_rank)


def free_port() -> int:
  """A TCP port free on this host now, for a process group's address."""
  import socket
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def close_world(world: World) -> None:
  if world.group is not None:
    import torch.distributed as dist
    dist.destroy_process_group()


def _communicates(world: World) -> bool:
  """Whether a collective over `world` goes through its process group
  (False: a world of one process without a group, whose collectives are
  identities). A world of several ranks without a group raises."""
  if world.group is None:
    if world.size > 1:
      raise ValueError(f'a collective over {world.size} ranks needs their '
                       'process group (init_world)')
    return False
  return True


def _via_host(world: World, t: torch.Tensor) -> bool:
  return world.backend == 'gloo' and t.is_cuda


def all_reduce_flat(tensors: 'list[torch.Tensor]', world: World,
                    op: str = 'sum') -> 'list[torch.Tensor]':
  """`tensors` (one dtype) reduced over the ranks ('sum' or 'max') by one
  all-reduce of their concatenation; new tensors of the same shapes. The
  result is the same on every rank."""
  flat = torch.cat([t.reshape(-1) for t in tensors])
  if _communicates(world):
    import torch.distributed as dist
    rop = {'sum': dist.ReduceOp.SUM, 'max': dist.ReduceOp.MAX}[op]
    if _via_host(world, flat):
      host = flat.cpu()
      dist.all_reduce(host, rop, group=world.group)
      flat = host.to(flat.device)
    else:
      dist.all_reduce(flat, rop, group=world.group)
  return [p.reshape(t.shape) for p, t in
          zip(flat.split([t.numel() for t in tensors]), tensors)]


def broadcast_(tensors: 'list[torch.Tensor]', world: World,
               src: int = 0) -> None:
  """Every tensor of `tensors` set in place to rank `src`'s."""
  if not _communicates(world):
    return
  import torch.distributed as dist
  for t in tensors:
    if _via_host(world, t):
      host = t.cpu()
      dist.broadcast(host, src, group=world.group)
      t.copy_(host)
    else:
      dist.broadcast(t, src, group=world.group)


def broadcast_object(obj: Any, world: World, src: int = 0) -> Any:
  """Rank `src`'s `obj` (any picklable object) on every rank."""
  if not _communicates(world):
    return obj
  import torch.distributed as dist
  box = [obj]
  dist.broadcast_object_list(box, src, group=world.group)
  return box[0]


def _all_gather(x: torch.Tensor, world: World) -> torch.Tensor:
  """(n_local, ...) of every rank -> (num_envs, ...) in rank order."""
  import torch.distributed as dist
  x = x.contiguous()
  if world.backend == 'nccl':
    x = x.to(world.device)
  elif x.is_cuda:
    x = x.cpu()
  as_bytes = x.dtype == torch.bool  # not every backend reduces bools
  if as_bytes:
    x = x.to(torch.uint8)
  parts = [torch.empty_like(x) for _ in range(world.size)]
  dist.all_gather(parts, x, group=world.group)
  out = torch.cat(parts)
  return out.to(torch.bool) if as_bytes else out


def _replicated(path, roots: frozenset, paths: frozenset) -> bool:
  """Whether the leaf at `path` (its keys from the tree's root) is every
  rank's alike: its root is one of `roots`, or its keys joined by '/' are
  one of `paths`, or begin with one of them that ends in '/'."""
  if path and str(path[0]) in roots:
    return True
  name = '/'.join(map(str, path))
  return any(name == p or (p.endswith('/') and name.startswith(p))
             for p in paths)


def _map(fn, tree, path=()):
  if isinstance(tree, dict):
    return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: _map(fn, getattr(tree, f.name), path + (f.name,))
        for f in dataclasses.fields(tree)})
  if isinstance(tree, (list, tuple)):
    return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
  return fn(path, tree)


def _is_array(x) -> bool:
  return isinstance(x, (np.ndarray, torch.Tensor))


def shard_batched(tree: Any, world: World, num_envs: 'int | None' = None,
                  replicated_subtrees: frozenset = REPLICATED_SUBTREES,
                  replicated_paths: frozenset = frozenset()) -> Any:
  """The rank's part of `tree` (nested dicts, lists, tuples and
  dataclasses of tensors or numpy arrays): every leaf with a leading axis
  of `num_envs` (the world's by default) cut to the rank's rows; every
  other leaf, and every leaf under a `replicated_subtrees` root or at a
  `replicated_paths` path (see _replicated), as it is. Works on a
  checkpoint's env state (with its env's replicated_state), a TrainState,
  observation dicts."""
  num_envs = world.num_envs if num_envs is None else num_envs
  assert_divisible(num_envs, world.size)
  n = num_envs // world.size
  lo = world.rank * n

  def cut(path, x):
    if (_is_array(x) and x.ndim >= 1 and x.shape[0] == num_envs
        and not _replicated(path, replicated_subtrees, replicated_paths)):
      return x[lo:lo + n]
    return x

  return _map(cut, tree)


def gather_env(tree: Any, world: World,
               replicated_subtrees: frozenset = REPLICATED_SUBTREES,
               replicated_paths: frozenset = frozenset()) -> Any:
  """The inverse of shard_batched, on every rank: each leaf with a leading
  axis of `n_local` that is not replicated gathered over the ranks into
  the global env's `num_envs` rows (numpy leaves stay numpy, tensors stay
  on their device); any other leaf but a 0-d one raises (check_env_axes).
  A collective: every rank of a sharded world calls it."""
  if not world.sharded:
    return tree
  check_env_axes(tree, world, replicated_subtrees, replicated_paths)
  _communicates(world)

  def gather(path, x):
    if not (_is_array(x) and x.ndim >= 1 and x.shape[0] == world.n_local
            and not _replicated(path, replicated_subtrees,
                                replicated_paths)):
      return x
    if isinstance(x, np.ndarray):
      return _all_gather(torch.from_numpy(x), world).cpu().numpy()
    return _all_gather(x, world).to(x.device)

  return _map(gather, tree)


def enable_sharding(train_state: Any, world: World) -> Any:
  """A TrainState whose env state and observations hold all of the
  world's envs (a carried or loaded state), made the rank's: its env state
  and observations cut to the rank's rows, its learner broadcast from rank
  0 so that every rank holds the same. The env state must be of a kind
  shard_batched reads (a plain dict of per-env leaves; a checkpoint's goes
  through OnPolicyRunner.load, which knows its env's replicated state)."""
  ts = train_state
  ts.env_state = shard_batched(ts.env_state, world)
  ts.obs = shard_batched(ts.obs, world)
  from mjlab_torch.rl.ppo import broadcast_learner
  broadcast_learner(ts, world)
  return ts


def check_env_axes(tree: Any, world: World,
                   replicated_subtrees: frozenset = REPLICATED_SUBTREES,
                   replicated_paths: frozenset = frozenset()) -> None:
  """Raise unless every array leaf of `tree` (an env state's numpy tree)
  that is not replicated has the env axis in front (`n_local` rows) or is
  0-d: a leaf of another shape would be neither cut nor gathered right,
  and its term must name it in its `replicated_state`."""
  bad = []

  def visit(path, x):
    if (_is_array(x) and x.ndim >= 1 and x.shape[0] != world.n_local
        and not _replicated(path, replicated_subtrees, replicated_paths)):
      bad.append('/'.join(map(str, path)) + f' {tuple(x.shape)}')
    return x

  _map(visit, tree)
  if bad:
    raise ValueError('env state leaves without the env axis in front and '
                     'named replicated by no term: ' + ', '.join(bad))
