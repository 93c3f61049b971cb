"""Minimal STL reader for robot visual meshes (numpy only), and the packed
form the shipped robots' meshes travel in.

Counterpart of mjlab_tpu/asset_zoo/stl.py. `load_stl` parses a binary or
ASCII STL into welded (vertices, faces) arrays, the form
`mujoco.MjSpec` meshes take as `uservert`/`userface`: the scene's specs
embed the vertex data, so composing a scene (`MjSpec.attach`) never
resolves a mesh directory.

The shipped G1 and Go1 meshes are not STL files: each robot's welded
meshes are packed into one lzma-compressed npz (`MESH_PACK` in its
assets directory, 2.9 MB for both robots against 24.4 MB of STL), which
`load_pack` reads. A pack holds, for each STL file name, exactly what
`load_stl` returns for that file (the faces delta-coded, which packs
tighter); `write_pack` makes one from a directory of STL files:

    python -m mjlab_torch.asset_zoo.stl <dir of STL files> <pack>
"""

from __future__ import annotations

import functools
import io
import lzma
import struct
import sys
from pathlib import Path

import numpy as np

MESH_PACK = 'meshes.npz.xz'


@functools.lru_cache(maxsize=None)
def load_stl(path: 'str | Path') -> 'tuple[np.ndarray, np.ndarray]':
  """Read an STL file -> (verts (V,3) float32, faces (F,3) int32).

  Vertices are deduplicated exactly (bitwise) so shared corners weld into
  a connected mesh; mujoco recomputes normals itself.
  """
  raw = Path(path).read_bytes()
  tris = _parse_binary(raw) if _is_binary(raw) else _parse_ascii(raw)
  # weld: exact-duplicate corners -> one vertex
  flat = tris.reshape(-1, 3)
  verts, inv = np.unique(flat, axis=0, return_inverse=True)
  faces = inv.reshape(-1, 3).astype(np.int32)
  # drop degenerate triangles (repeated corner after welding)
  ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2]))
  return verts.astype(np.float32), faces[ok]


def _is_binary(raw: bytes) -> bool:
  # ASCII STL starts with 'solid', but some binary files do too: trust
  # the triangle-count arithmetic over the magic word.
  if len(raw) < 84:
    return False
  (ntri,) = struct.unpack_from('<I', raw, 80)
  return len(raw) == 84 + 50 * ntri


def _parse_binary(raw: bytes) -> np.ndarray:
  (ntri,) = struct.unpack_from('<I', raw, 80)
  body = np.frombuffer(raw, dtype=np.uint8, count=50 * ntri, offset=84)
  rec = body.reshape(ntri, 50)
  # 12 bytes normal, 3x12 bytes vertices, 2 bytes attribute
  vals = rec[:, :48].reshape(ntri, 4, 12).copy().view(np.float32)
  return vals[:, 1:4, :3].reshape(ntri, 3, 3)


def _parse_ascii(raw: bytes) -> np.ndarray:
  coords = []
  for line in raw.decode('ascii', errors='replace').splitlines():
    parts = line.split()
    if parts[:1] == ['vertex']:
      coords.append([float(parts[1]), float(parts[2]), float(parts[3])])
  arr = np.asarray(coords, dtype=np.float32)
  if arr.size == 0 or len(arr) % 3:
    raise ValueError('malformed ASCII STL')
  return arr.reshape(-1, 3, 3)


def write_pack(stl_dir: 'str | Path', out: 'str | Path') -> list:
  """Pack the welded meshes of every STL file in `stl_dir` into `out`;
  returns the file names packed."""
  files = sorted(p for p in Path(stl_dir).iterdir()
                 if p.suffix.lower() == '.stl')
  arrays = {}
  for p in files:
    verts, faces = load_stl(str(p))
    arrays[f'{p.name}.vert'] = verts
    arrays[f'{p.name}.face'] = np.diff(faces.reshape(-1).astype(np.int64),
                                       prepend=0).astype(np.int32)
  buf = io.BytesIO()
  np.savez(buf, **arrays)
  Path(out).write_bytes(lzma.compress(
      buf.getvalue(), preset=9 | lzma.PRESET_EXTREME))
  return [p.name for p in files]


@functools.lru_cache(maxsize=None)
def load_pack(path: 'str | Path') -> 'dict[str, tuple]':
  """{STL file name: (verts, faces)} of a pack written by `write_pack`,
  each entry what `load_stl` returns for that file."""
  with np.load(io.BytesIO(lzma.decompress(Path(path).read_bytes()))) as z:
    names = sorted({k.rsplit('.', 1)[0] for k in z.files})
    return {n: (z[f'{n}.vert'],
                np.cumsum(z[f'{n}.face']).astype(np.int32).reshape(-1, 3))
            for n in names}


if __name__ == '__main__':
  print(write_pack(sys.argv[1], sys.argv[2]))
