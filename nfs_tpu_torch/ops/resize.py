"""Octave up/down-resampling (counterpart of ``nfs_tpu/ops/resize.py``).

``resize`` reproduces ``jax.image.resize(method='linear')``, antialiasing
included: per axis an ``(in, out)`` weight matrix built in numpy exactly
as ``jax/_src/image/scale.py`` ``compute_weight_mat`` builds it (the
triangle kernel is widened by ``1/scale`` when downsampling, columns are
normalised, samples outside the input are zeroed), then contracted with
``torch.tensordot``. ``torch.nn.functional.interpolate`` does not
antialias and differs by up to ~0.5 when downsampling.

Resizing a velocity field also rescales each component so that "cells
per frame" stays consistent at the new resolution.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 linear-resize weights, antialiased."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=256)
def _weights_on(in_size: int, out_size: int, device: str) -> torch.Tensor:
    return torch.from_numpy(weight_matrix(in_size, out_size)).to(device)


def resize_axes(x: torch.Tensor, axes: Sequence[int],
                sizes: Sequence[int]) -> torch.Tensor:
    """Linear (antialiased) resize of the given axes of ``x`` to
    ``sizes``; axes whose size already matches are left alone."""
    for ax, n in zip(axes, sizes):
        m = x.shape[ax]
        if m == n:
            continue
        w = _weights_on(m, n, str(x.device)).to(x.dtype)
        x = torch.tensordot(x, w, dims=([ax], [0])).movedim(-1, ax)
    return x


def resize(field: torch.Tensor, shape: Tuple[int, ...],
           is_velocity: bool = False) -> torch.Tensor:
    """Resize the spatial axes of a field to ``shape``.

    Args:
      field: ``(*spatial)`` or ``(*spatial, C)``.
      shape: target spatial shape (len = ndim_space).
      is_velocity: the trailing axis is a velocity channel axis and each
        component is multiplied by new_size/old_size of its axis.
    """
    ndim = len(shape)
    out = resize_axes(field, range(ndim), shape)
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
