"""Mantaflow ``.uni`` codec (counterpart of ``nfs_tpu/io/uni.py``, a
copy: the module is numpy only, and the port imports nothing of the JAX
package). Header fields: magic MNT2/MNT3, dimX/Y/Z, gridType,
elementType, bytesPerElement, timestamp; compressed payload.

Format notes (from the public mantaflow C++ fileio): files are written
through ``gzopen``/``gzwrite``, i.e. **the whole file is one gzip stream**
containing ``magic(4) | header struct | raw payload``. Grid magics:
``MNT2`` (legacy) / ``MNT3`` (adds dimT); particle-system magics
``PB01``/``PB02``; particle-data magic ``PD01``.

The readers are deliberately tolerant: they
accept gzip-wrapped or raw streams and both packed and naturally-aligned
header layouts, picking whichever is consistent with the payload size.
The writers emit the naturally-aligned MNT3 / PB02 / PD01 layouts.

Element types (mantaflow GridBase::GridType / ParticleBase):
  grids: 0 = int32, 1 = float32 (Real), 2 = 3 x float32 (Vec3)
"""

from __future__ import annotations

import gzip
import struct
import time
from dataclasses import dataclass
from typing import Tuple

import numpy as np

_GZIP_MAGIC = b"\x1f\x8b"

# header struct candidates: (struct fmt after the 4-byte magic, has_dimT)
# MNT3 natural alignment: 6i (24) + 256s (280) + i dimT (284) + pad(4) + Q
_MNT3_ALIGNED = "<6i256si4xQ"
_MNT3_PACKED = "<6i256siQ"
_MNT2_ALIGNED = "<6i256s4xQ"
_MNT2_PACKED = "<6i256sQ"

# particle system header (PB02): dim(#particles), dimX, dimY, dimZ,
# elementType, bytesPerElement, info[256], timestamp
_PB02_ALIGNED = "<6i256s4xQ"
_PB02_PACKED = "<6i256sQ"

_ELEM_DTYPES = {0: np.int32, 1: np.float32, 2: np.float32}


@dataclass
class UniHeader:
    magic: str
    dim: Tuple[int, int, int]
    grid_type: int
    element_type: int
    bytes_per_element: int
    info: str
    dim_t: int
    timestamp: int


def _maybe_decompress(raw: bytes) -> bytes:
    if raw[:2] == _GZIP_MAGIC:
        return gzip.decompress(raw)
    return raw


def _parse_grid_header(data: bytes):
    magic = data[:4].decode("ascii", errors="replace")
    if magic == "MNT3":
        candidates = [( _MNT3_ALIGNED, True), (_MNT3_PACKED, True)]
    elif magic == "MNT2":
        candidates = [(_MNT2_ALIGNED, False), (_MNT2_PACKED, False)]
    else:
        raise ValueError(f"not a mantaflow grid .uni file (magic={magic!r})")

    for fmt, has_dim_t in candidates:
        size = struct.calcsize(fmt)
        if len(data) < 4 + size:
            continue
        fields = struct.unpack_from(fmt, data, 4)
        dim_x, dim_y, dim_z, grid_type, elem_type, bpe = fields[:6]
        info = fields[6]
        dim_t = fields[7] if has_dim_t else 1
        timestamp = fields[-1]
        n_cells = dim_x * dim_y * dim_z * max(dim_t, 1)
        expected = n_cells * bpe
        if len(data) - 4 - size == expected and 0 < bpe <= 64:
            header = UniHeader(
                magic=magic, dim=(dim_x, dim_y, dim_z), grid_type=grid_type,
                element_type=elem_type, bytes_per_element=bpe,
                info=info.split(b"\x00")[0].decode("utf-8", errors="replace"),
                dim_t=max(dim_t, 1), timestamp=timestamp,
            )
            return header, 4 + size
    raise ValueError("could not parse .uni grid header (unknown layout)")


def read_uni(path: str, manta_order: bool = False
             ) -> Tuple[np.ndarray, UniHeader]:
    """Read a mantaflow grid .uni file.

    Returns (array, header). Scalar grids -> (Z, Y, X); Vec3 grids ->
    (Z, Y, X, 3) with channels (vx, vy, vz), or array-axis order
    (vz, vy, vx) if ``manta_order`` is False (the framework convention).
    """
    with open(path, "rb") as f:
        data = _maybe_decompress(f.read())
    header, offset = _parse_grid_header(data)
    dim_x, dim_y, dim_z = header.dim
    dtype = _ELEM_DTYPES.get(header.element_type, np.float32)
    payload = np.frombuffer(data, dtype=dtype, offset=offset)
    n_comp = header.bytes_per_element // np.dtype(dtype).itemsize
    if n_comp > 1:
        arr = payload.reshape(dim_z, dim_y, dim_x, n_comp)
        if not manta_order and n_comp == 3:
            arr = arr[..., ::-1]  # (vx,vy,vz) -> axis order (vz,vy,vx)
    else:
        arr = payload.reshape(dim_z, dim_y, dim_x)
    return np.ascontiguousarray(arr), header


def write_uni(path: str, arr: np.ndarray, info: str = "nfs_tpu",
              manta_order: bool = False, compress: bool = True) -> None:
    """Write a grid as MNT3 .uni. (Z, Y, X[, 3]) input; a trailing 3-channel
    axis is stored as Vec3 in mantaflow (vx, vy, vz) channel order."""
    arr = np.asarray(arr)
    if arr.ndim == 4:
        if not manta_order:
            arr = arr[..., ::-1]
        elem_type, n_comp = 2, arr.shape[-1]
        dim_z, dim_y, dim_x = arr.shape[:3]
        payload = np.ascontiguousarray(arr, dtype=np.float32)
    elif arr.ndim == 3:
        if np.issubdtype(arr.dtype, np.integer):
            elem_type = 0
            payload = np.ascontiguousarray(arr, dtype=np.int32)
        else:
            elem_type = 1
            payload = np.ascontiguousarray(arr, dtype=np.float32)
        n_comp = 1
        dim_z, dim_y, dim_x = arr.shape
    else:
        raise ValueError(f"expected (Z,Y,X) or (Z,Y,X,3), got {arr.shape}")

    bpe = 4 * n_comp
    head = struct.pack(
        _MNT3_ALIGNED, dim_x, dim_y, dim_z, 1, elem_type, bpe,
        info.encode("utf-8")[:255], 1, int(time.time()),
    )
    blob = b"MNT3" + head + payload.tobytes()
    if compress:
        blob = gzip.compress(blob, compresslevel=1)
    with open(path, "wb") as f:
        f.write(blob)


def read_uni_particles(path: str, manta_order: bool = False
                       ) -> Tuple[np.ndarray, UniHeader]:
    """Read a mantaflow particle-system .uni (PB01/PB02): returns
    (N, 3) positions. BasicParticleData layout: Vec3 pos + int32 flag."""
    with open(path, "rb") as f:
        data = _maybe_decompress(f.read())
    magic = data[:4].decode("ascii", errors="replace")
    if magic not in ("PB01", "PB02"):
        raise ValueError(f"not a particle .uni file (magic={magic!r})")
    for fmt in (_PB02_ALIGNED, _PB02_PACKED):
        size = struct.calcsize(fmt)
        if len(data) < 4 + size:
            continue
        n, dim_x, dim_y, dim_z, elem_type, bpe, info, ts = struct.unpack_from(
            fmt, data, 4)
        if len(data) - 4 - size == n * bpe and 0 < bpe <= 64:
            raw = np.frombuffer(data, dtype=np.float32, offset=4 + size)
            rec = raw.reshape(n, bpe // 4)
            pos = rec[:, :3]  # (x, y, z) world/cell coords
            if not manta_order:
                pos = pos[:, ::-1]
            header = UniHeader(
                magic=magic, dim=(dim_x, dim_y, dim_z), grid_type=0,
                element_type=elem_type, bytes_per_element=bpe,
                info=info.split(b"\x00")[0].decode("utf-8", errors="replace"),
                dim_t=1, timestamp=ts,
            )
            return np.ascontiguousarray(pos), header
    raise ValueError("could not parse particle .uni header")


def write_uni_particles(path: str, pos: np.ndarray, grid_dim=(0, 0, 0),
                        info: str = "nfs_tpu", manta_order: bool = False,
                        compress: bool = True) -> None:
    """Write (N, 3) positions as PB02 (pos Vec3 + zero int flag)."""
    pos = np.asarray(pos, dtype=np.float32)
    if not manta_order:
        pos = pos[:, ::-1]
    n = pos.shape[0]
    rec = np.zeros((n, 4), dtype=np.float32)
    rec[:, :3] = pos
    head = struct.pack(
        _PB02_ALIGNED, n, grid_dim[2], grid_dim[1], grid_dim[0], 0, 16,
        info.encode("utf-8")[:255], int(time.time()),
    )
    blob = b"PB02" + head + rec.tobytes()
    if compress:
        blob = gzip.compress(blob, compresslevel=1)
    with open(path, "wb") as f:
        f.write(blob)


def read_uni_pdata(path: str) -> Tuple[np.ndarray, UniHeader]:
    """Read a mantaflow particle-data .uni (PD01): per-particle scalar
    (N,), int (N,), or Vec3 (N, 3) attribute arrays (the pdata files that
    accompany PB02 particle systems)."""
    with open(path, "rb") as f:
        data = _maybe_decompress(f.read())
    magic = data[:4].decode("ascii", errors="replace")
    if magic != "PD01":
        raise ValueError(f"not a particle-data .uni file (magic={magic!r})")
    # header: dim (N), dimX/Y/Z (unused), elementType, bytesPerElement,
    # info[256], timestamp — same struct family as PB02
    for fmt in (_PB02_ALIGNED, _PB02_PACKED):
        size = struct.calcsize(fmt)
        if len(data) < 4 + size:
            continue
        n, dx, dy, dz, elem_type, bpe, info, ts = struct.unpack_from(
            fmt, data, 4)
        if len(data) - 4 - size == n * bpe and 0 < bpe <= 64:
            dtype = np.int32 if elem_type == 0 else np.float32
            raw = np.frombuffer(data, dtype=dtype, offset=4 + size)
            n_comp = bpe // 4
            arr = raw.reshape(n, n_comp) if n_comp > 1 else raw.copy()
            header = UniHeader(
                magic=magic, dim=(dx, dy, dz), grid_type=0,
                element_type=elem_type, bytes_per_element=bpe,
                info=info.split(b"\x00")[0].decode("utf-8",
                                                   errors="replace"),
                dim_t=1, timestamp=ts)
            return np.ascontiguousarray(arr), header
    raise ValueError("could not parse particle-data .uni header")


def write_uni_pdata(path: str, arr: np.ndarray, info: str = "nfs_tpu",
                    compress: bool = True) -> None:
    """Write per-particle data as PD01: (N,) float/int or (N, 3) float."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if arr.ndim == 2:
        elem_type, bpe = 2, 4 * arr.shape[1]
        payload = np.ascontiguousarray(arr, dtype=np.float32)
    elif np.issubdtype(arr.dtype, np.integer):
        elem_type, bpe = 0, 4
        payload = np.ascontiguousarray(arr, dtype=np.int32)
    else:
        elem_type, bpe = 1, 4
        payload = np.ascontiguousarray(arr, dtype=np.float32)
    head = struct.pack(_PB02_ALIGNED, n, 0, 0, 0, elem_type, bpe,
                       info.encode("utf-8")[:255], int(time.time()))
    blob = b"PD01" + head + payload.tobytes()
    if compress:
        blob = gzip.compress(blob, compresslevel=1)
    with open(path, "wb") as f:
        f.write(blob)
