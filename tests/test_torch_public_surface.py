"""The port's public surface, name for name: every public top-level name of
each module of the JAX package exists in the port's module of the same
path, except the JAX/TPU-only concepts of ALLOWLIST, each with its reason.

Both packages are read with `ast`; nothing is imported, JAX least of all.
A public name is a def, a class, an assignment, or a re-export from the
package's own modules (`from mjlab_tpu.x import y`, relative imports), at
the top level or under a top-level `if`/`try` other than the `__main__`
guard, and not starting with an underscore. Imports of anything else (the
standard library, typing, numpy, mujoco, jax, flax, optax, orbax) are not
public names: so `pl`, `pltpu` (Pallas), `struct` (flax) and `Mesh`,
`NamedSharding`, `P` (jax.sharding) need no entry. Each module is one
case; another case fails on an allowlist entry that the port now has, or
that no longer names a public name of the JAX module."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = 'mjlab_tpu', 'mjlab_torch'

_CACHE = ('XLA\'s persistent compile cache; the port builds its kernels '
          'into its own cache (ops/_build.py)')
_VMAP = ('jax.vmap in_axes of a Model with per-env fields; the port indexes '
         'a per-env field on its env axis and maps nothing')
ALLOWLIST = {
    ('ops/newton.py', 'newton_solve_tpu'):
        'the Pallas TPU entry of K2; the port\'s is newton_solve_cuda',
    ('ops/smooth_kernel.py', 'smooth_fused_tpu'):
        'the Pallas TPU entry of K3; the port\'s is smooth_fused_cuda',
    ('envs/manager_based_rl_env.py', 'model_vmap_axes'): _VMAP,
    ('sim/sim.py', 'model_vmap_axes'): _VMAP,
    ('parallel/sharding.py', 'make_mesh'):
        'a jax.sharding Mesh over the devices; the port shards over '
        'torch.distributed (parallel/sharding.py: World, init_world)',
    ('utils/cache.py', 'apply_platform_env'): _CACHE,
    ('utils/cache.py', 'cpu_cache_dir'): _CACHE,
    ('utils/cache.py', 'setup_compilation_cache'): _CACHE,
    ('rl/runner.py', 'jnp_asarray_like'):
        'casts host arrays to jax arrays of a template\'s dtype; the '
        'port\'s tensors come to the runner as torch tensors',
}


def _targets(node) -> 'list[str]':
  """The plain names an assignment target binds."""
  if isinstance(node, ast.Name):
    return [node.id]
  if isinstance(node, (ast.Tuple, ast.List)):
    return [n for e in node.elts for n in _targets(e)]
  if isinstance(node, ast.Starred):
    return _targets(node.value)
  return []


def _is_main_guard(node) -> bool:
  t = node.test
  return (isinstance(t, ast.Compare) and isinstance(t.left, ast.Name)
          and t.left.id == '__name__')


def _bound(body, pkg: str):
  for node in body:
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
      yield node.name
    elif isinstance(node, ast.Assign):
      for t in node.targets:
        yield from _targets(t)
    elif isinstance(node, ast.AnnAssign):
      yield from _targets(node.target)
    elif isinstance(node, ast.ImportFrom):
      if node.level or (node.module or '').split('.')[0] == pkg:
        for a in node.names:
          yield a.asname or a.name
    elif isinstance(node, ast.Import):
      for a in node.names:
        if a.name.split('.')[0] == pkg:
          yield a.asname or a.name.split('.')[0]
    elif isinstance(node, ast.If) and not _is_main_guard(node):
      yield from _bound(node.body + node.orelse, pkg)
    elif isinstance(node, ast.Try):
      yield from _bound(node.body + node.orelse + node.finalbody, pkg)
      for h in node.handlers:
        yield from _bound(h.body, pkg)


def public_names(path: pathlib.Path, pkg: str) -> 'set[str]':
  """The public top-level names of the module at `path` of package
  `pkg`."""
  tree = ast.parse(path.read_text(), filename=str(path))
  return {n for n in _bound(tree.body, pkg) if not n.startswith('_')}


def _modules() -> 'list[str]':
  base = ROOT / JAX_PKG
  return sorted(str(p.relative_to(base)) for p in base.rglob('*.py'))


def missing(module: str) -> 'list[str]':
  """The JAX module's public names that the port's module lacks, less the
  allowlisted ones."""
  want = public_names(ROOT / JAX_PKG / module, JAX_PKG)
  port = ROOT / PORT_PKG / module
  have = public_names(port, PORT_PKG) if port.exists() else set()
  return sorted(n for n in want - have if (module, n) not in ALLOWLIST)


MODULES = _modules()


def test_the_walk_sees_both_packages(tmp_path):
  """The walk reaches the modules the audit is about, and reads the kinds
  of public name it should: defs, classes, assignments, re-exports, names
  bound by tuple assignment and under a top-level `if`; not third-party
  imports or private names."""
  assert len(MODULES) > 100
  for m in ('envs/mdp/events.py', 'physics/__init__.py', 'utils/math.py',
            'terrains/__init__.py', 'asset_zoo/unitree_g1.py'):
    assert m in MODULES, m
  ev = public_names(ROOT / JAX_PKG / 'envs/mdp/events.py', JAX_PKG)
  # `tmath` is mjlab_tpu.utils.math under another name: a re-export
  assert {'apply_external_force_torque', 'FieldSpec', 'FIELD_SPECS',
          'SceneEntityCfg', 'tmath'} <= ev
  assert not ev & {'jax', 'jnp', 'np', 'dataclasses', 'Dict', '_DEFAULT'}
  sensor = public_names(ROOT / JAX_PKG / 'physics/sensor.py', JAX_PKG)
  assert {'OBJ_BODY', 'SUPPORTED', 'REDUCE_NETFORCE'} <= sensor
  assert not public_names(ROOT / JAX_PKG / 'ops/pd_solve.py',
                          JAX_PKG) & {'pl', 'pltpu'}
  src = ('import numpy as np\nfrom x import y\nfrom .z import w\n'
         'A, (B, *C) = 1, (2, 3)\nif True:\n  D = 1\nelse:\n  E = 2\n'
         'try:\n  F = 1\nexcept ImportError:\n  G = 2\n'
         'if __name__ == "__main__":\n  H = 1\nobj.attr = 1\n_I = 1\n')
  path = tmp_path / 'probe.py'
  path.write_text(src)
  assert public_names(path, 'pkg') == {'w', 'A', 'B', 'C', 'D', 'E', 'F', 'G'}


@pytest.mark.parametrize('module', MODULES)
def test_module_has_every_public_name(module):
  gone = missing(module)
  assert not gone, (f'{PORT_PKG}/{module} lacks public names of '
                    f'{JAX_PKG}/{module}: {gone}')


def test_allowlist_is_not_stale():
  """Every entry names a public name of its JAX module that the port's
  module still lacks, and says why it is JAX/TPU-only."""
  stale = []
  for (module, name), reason in ALLOWLIST.items():
    assert reason and len(reason) > 20, (module, name)
    jax_path, port = ROOT / JAX_PKG / module, ROOT / PORT_PKG / module
    if not jax_path.exists() or name not in public_names(jax_path, JAX_PKG):
      stale.append((module, name, f'not a public name of {JAX_PKG}'))
    elif port.exists() and name in public_names(port, PORT_PKG):
      stale.append((module, name, f'{PORT_PKG} has it now'))
  assert not stale, stale
