""".npz frame store (reference: ``util.py`` frame load/save, SURVEY.md §2).

The reference's data contract with mantaflow: per-frame files
``d_%04d.npz`` (density), ``v_%04d.npz`` (velocity), ``p_%04d.npz``
(particles), each containing a single array (or an array per key).
Mantaflow arrays are indexed (z, y, x) with velocity channels (vx, vy, vz);
our in-framework convention (see nfs_tpu/core/pytrees.py) keeps (z, y, x)
indexing but stores velocity channels in array-axis order (vz, vy, vx) —
``manta_order=True`` converts on load/save.

Frame outputs are the implicit checkpoint (SURVEY.md §5 failure-recovery):
`FrameStore.exists` lets drivers skip already-stylized frames.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _first_array(npz) -> np.ndarray:
    if len(npz.files) == 1:
        return npz[npz.files[0]]
    for key in ("d", "v", "p", "x", "data", "arr_0"):
        if key in npz.files:
            return npz[key]
    return npz[npz.files[0]]


def load_frame(path: str, manta_order: bool = False) -> np.ndarray:
    """Load a single-array frame file. Flips a trailing velocity channel
    axis from mantaflow (x, y, z) order to array-axis order if asked."""
    with np.load(path) as npz:
        arr = np.asarray(_first_array(npz))
    if manta_order and arr.ndim >= 2 and arr.shape[-1] == arr.ndim - 1:
        arr = arr[..., ::-1].copy()
    return arr


def save_frame(path: str, arr: np.ndarray, key: str = "d",
               manta_order: bool = False) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(arr)
    if manta_order and arr.ndim >= 2 and arr.shape[-1] == arr.ndim - 1:
        arr = arr[..., ::-1].copy()
    np.savez_compressed(path, **{key: arr})


class FrameStore:
    """Pattern-addressed per-frame arrays, mirroring the reference layout.

    >>> store = FrameStore("data/smoke", d_path="d_%04d.npz")
    >>> d0 = store.load_density(0)
    """

    def __init__(self, data_dir: str, d_path: str = "d_%04d.npz",
                 v_path: str = "v_%04d.npz", p_path: str = "p_%04d.npz",
                 manta_order: bool = False):
        self.data_dir = data_dir
        self.d_path = d_path
        self.v_path = v_path
        self.p_path = p_path
        self.manta_order = manta_order

    def _path(self, pattern: str, frame: int) -> str:
        return os.path.join(self.data_dir, pattern % frame)

    def exists(self, pattern: str, frame: int) -> bool:
        return os.path.exists(self._path(pattern, frame))

    def load_density(self, frame: int) -> np.ndarray:
        return load_frame(self._path(self.d_path, frame))

    def load_velocity(self, frame: int) -> np.ndarray:
        return load_frame(self._path(self.v_path, frame),
                          manta_order=self.manta_order)

    def load_particles(self, frame: int) -> Dict[str, np.ndarray]:
        """Particle frames may hold several keys: x (positions), dens,
        color, vel."""
        path = self._path(self.p_path, frame)
        out = {}
        with np.load(path) as npz:
            for key in npz.files:
                out[key] = np.asarray(npz[key])
        if "x" not in out and out:
            first = sorted(out.keys())[0]
            out["x"] = out.pop(first)
        if self.manta_order and "x" in out and out["x"].ndim == 2:
            out["x"] = out["x"][..., ::-1].copy()
            if "vel" in out:
                out["vel"] = out["vel"][..., ::-1].copy()
        return out

    def save_density(self, frame: int, d: np.ndarray) -> None:
        save_frame(self._path(self.d_path, frame), d, key="d")

    def save_velocity(self, frame: int, v: np.ndarray) -> None:
        save_frame(self._path(self.v_path, frame), v, key="v",
                   manta_order=self.manta_order)

    def save_particles(self, frame: int, **arrays: np.ndarray) -> None:
        path = self._path(self.p_path, frame)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self.manta_order:
            arrays = dict(arrays)
            for key in ("x", "vel"):
                if key in arrays and arrays[key].ndim == 2:
                    arrays[key] = arrays[key][..., ::-1].copy()
        np.savez_compressed(path, **arrays)
