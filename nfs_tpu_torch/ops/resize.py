"""Octave up/down-resampling (counterpart of ``nfs_tpu/ops/resize.py``).

``resize`` reproduces ``jax.image.resize`` for each method it takes,
antialiasing included: per axis an ``(in, out)`` weight matrix built in
numpy exactly as ``jax/_src/image/scale.py`` ``compute_weight_mat``
builds it (the kernel -- triangle, Keys cubic, Lanczos 3 or 5 -- is
widened by ``1/scale`` when downsampling, columns are normalised,
samples outside the input are zeroed), then contracted with
``torch.tensordot``; ``nearest`` takes jax's own rule, an index per
output cell. ``torch.nn.functional.interpolate`` does not antialias and
differs by up to ~0.5 when downsampling.

Resizing a velocity field also rescales each component so that "cells
per frame" stays consistent at the new resolution.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

_F32 = np.float32


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(_F32(0.0), _F32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5."""
    out = ((_F32(1.5) * x - _F32(2.5)) * x) * x + _F32(1.0)
    out = np.where(x >= 1.0, ((_F32(-0.5) * x + _F32(2.5)) * x - _F32(4.0))
                   * x + _F32(2.0), out)
    return np.where(x >= 2.0, _F32(0.0), out)


def _lanczos(radius: float):
    r = _F32(radius)

    def kernel(x: np.ndarray) -> np.ndarray:
        y = r * np.sin(_F32(np.pi) * x) * np.sin(_F32(np.pi) * x / r)
        out = np.where(x > 1e-3, y / np.where(x != 0, _F32(np.pi ** 2)
                                              * x ** 2, _F32(1.0)),
                       _F32(1.0))
        return np.where(x > r, _F32(0.0), out)
    return kernel


# jax.image.ResizeMethod's names and their kernels (None: nearest)
_KERNELS = {"nearest": None, "linear": _triangle, "lanczos3": _lanczos(3.0),
            "lanczos5": _lanczos(5.0), "cubic": _keys_cubic}
_ALIASES = {"bilinear": "linear", "trilinear": "linear",
            "triangle": "linear", "bicubic": "cubic", "tricubic": "cubic"}


def _canonical(method: str) -> str:
    """The canonical name of a ``jax.image.resize`` method, ValueError
    for an unknown one (jax's wording)."""
    name = _ALIASES.get(method, method)
    if name not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    return name


@functools.lru_cache(maxsize=None)
def weight_matrix(in_size: int, out_size: int,
                  method: str = "linear") -> np.ndarray:
    """(in_size, out_size) float32 resize weights of a kernel method,
    antialiased."""
    kernel = _KERNELS[_canonical(method)]
    if kernel is None:
        raise ValueError("nearest resizing takes indices, not weights")
    scale = out_size / in_size
    inv_scale = _F32(1.0 / scale)
    kernel_scale = max(inv_scale, _F32(1.0))
    sample_f = ((np.arange(out_size, dtype=_F32) + _F32(0.5)) * inv_scale
                - _F32(0.0) * inv_scale - _F32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=_F32)[:, None])
         / kernel_scale)
    w = kernel(x).astype(_F32)
    total = w.sum(axis=0, keepdims=True, dtype=_F32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, _F32(1.0)), _F32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, _F32(0.0)).astype(_F32)


@functools.lru_cache(maxsize=None)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """jax.image.resize's nearest rule: output cell i reads input
    floor((i + 0.5) * in / out), computed in float32."""
    offsets = ((np.arange(out_size, dtype=_F32) + _F32(0.5)) * _F32(in_size)
               / _F32(out_size))
    return np.floor(offsets).astype(np.int64)


@functools.lru_cache(maxsize=256)
def _weights_on(in_size: int, out_size: int, device: str,
                method: str = "linear") -> torch.Tensor:
    if _KERNELS[method] is None:
        return torch.from_numpy(_nearest_indices(in_size, out_size)).to(
            device)
    return torch.from_numpy(weight_matrix(in_size, out_size, method)).to(
        device)


def resize_axes(x: torch.Tensor, axes: Sequence[int],
                sizes: Sequence[int], method: str = "linear"
                ) -> torch.Tensor:
    """Resize of the given axes of ``x`` to ``sizes`` by a
    ``jax.image.resize`` method (antialiased); axes whose size already
    matches are left alone."""
    method = _canonical(method)
    for ax, n in zip(axes, sizes):
        m = x.shape[ax]
        if m == n:
            continue
        w = _weights_on(m, n, str(x.device), method)
        if _KERNELS[method] is None:
            x = x.index_select(ax, w)
        else:
            x = torch.tensordot(x, w.to(x.dtype),
                                dims=([ax], [0])).movedim(-1, ax)
    return x


def resize(field: torch.Tensor, shape: Tuple[int, ...],
           is_velocity: bool = False, method: str = "linear"
           ) -> torch.Tensor:
    """Resize the spatial axes of a field to ``shape``.

    Args:
      field: ``(*spatial)`` or ``(*spatial, C)``.
      shape: target spatial shape (len = ndim_space).
      is_velocity: the trailing axis is a velocity channel axis and each
        component is multiplied by new_size/old_size of its axis.
      method: a ``jax.image.resize`` method: ``nearest``, ``linear``
        (``bilinear``, ``trilinear``, ``triangle``), ``cubic``
        (``bicubic``, ``tricubic``), ``lanczos3`` or ``lanczos5``.
    """
    ndim = len(shape)
    out = resize_axes(field, range(ndim), shape, method)
    if is_velocity:
        scale = torch.tensor([shape[i] / field.shape[i] for i in range(ndim)],
                             dtype=out.dtype, device=out.device)
        out = out * scale
    return out


def resize_frames(x: torch.Tensor, shape: Tuple[int, ...],
                  is_velocity: bool = False) -> torch.Tensor:
    """:func:`resize` of every frame of a (T, *spatial[, C]) stack, in
    one contraction per axis."""
    ndim = len(shape)
    out = resize_axes(x, range(1, 1 + ndim), shape)
    if is_velocity:
        scale = torch.tensor([shape[i] / x.shape[1 + i] for i in range(ndim)],
                             dtype=out.dtype, device=out.device)
        out = out * scale
    return out


def octave_shape(shape: Sequence[int], octave: int, octave_n: int,
                 octave_scale: float) -> Tuple[int, ...]:
    """Spatial shape at `octave` (0 = coarsest, octave_n-1 = full res)."""
    factor = octave_scale ** (octave_n - 1 - octave)
    return tuple(max(1, int(round(s / factor))) for s in shape)


def octave_shapes(shape: Sequence[int], octave_n: int,
                  octave_scale: float) -> Tuple[Tuple[int, ...], ...]:
    """All octave shapes, coarse to fine; the last equals `shape`."""
    out = [
        octave_shape(shape, o, octave_n, octave_scale)
        for o in range(octave_n - 1)
    ]
    out.append(tuple(shape))
    return tuple(out)
