"""Mantaflow ``.uni`` codec (counterpart of ``nfs_tpu/io/uni.py``, a
copy: the module is numpy only, and the port imports nothing of the JAX
package). Header fields: magic MNT2/MNT3, dimX/Y/Z, gridType,
elementType, bytesPerElement, timestamp; compressed payload.

Format notes (from the public mantaflow C++ fileio): files are written
through ``gzopen``/``gzwrite``, i.e. **the whole file is one gzip stream**
containing ``magic(4) | header struct | raw payload``. Grid magics:
``MNT2`` (legacy) / ``MNT3`` (adds dimT). The JAX module's particle
codecs (``PB02``, ``PD01``) are not copied: nothing in the port reads or
writes particle ``.uni`` files yet.

The reader is deliberately tolerant: it
accepts gzip-wrapped or raw streams and both packed and naturally-aligned
header layouts, picking whichever is consistent with the payload size.
The writer emits the naturally-aligned MNT3 layout.

Element types (mantaflow GridBase::GridType):
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

