"""Differentiable particle-to-grid splatting (counterpart of
``nfs_tpu/ops/splat.py``; LNST §4.1).

``splat(x, attr, shape)`` scatters per-particle attributes onto a grid
with a compact smoothing kernel, differentiable in the attributes and,
through the kernel weights, in the particle positions. The JAX package
leaves this to XLA, so it is plain torch here: every tap of every
particle goes into ONE ``index_add`` (out-of-range taps get a sentinel
row that is dropped), and ``gather`` is its grid-to-particle twin.

Kernels: 'linear' (tent, 2^d taps) and 'bspline' (quadratic B-spline,
3^d taps at unit support, centred base floor(x - 0.5)). The linear
tent's gradient is taken as JAX takes it: abs'(0) = +1 and 0.5 where
``max(1 - |u|, 0)`` ties (ROADMAP queue 3, F1 and F6); torch's own
``abs`` and ``clamp`` give 0 and 1 there.
"""

from __future__ import annotations

import itertools
import math
from typing import Tuple

import torch

from nfs_tpu_torch.ops.jaxgrad import jax_tent
from nfs_tpu_torch.utils.profiling import span


def _kernel_weight_1d(u: torch.Tensor, kernel: str) -> torch.Tensor:
    """Kernel value at signed distance u (cells), unit support."""
    if kernel == "linear":
        return jax_tent(u)
    if kernel == "bspline":
        au = u.abs()
        return torch.where(au < 0.5, 0.75 - au * au,
                           torch.where(au < 1.5, 0.5 * (1.5 - au) ** 2,
                                       0.0))
    raise ValueError(f"unknown kernel {kernel!r}")


def _base_and_stencil(xf: torch.Tensor, kernel: str, support: float):
    """Per-axis integer base nodes + (lo, n_taps) of the tap stencil; the
    unit-support B-spline uses the centred base floor(x - 0.5) and 3 taps
    per axis (ops/splat.py ``_base_and_stencil``)."""
    xf = xf.detach()
    if kernel == "bspline" and support == 1.0:
        return torch.floor(xf - 0.5).long(), 0, 3
    radius = (1.0 if kernel == "linear" else 1.5) * support
    lo = int(math.floor(-radius)) + 1
    hi = int(math.ceil(radius + 1.0))  # exclusive
    return torch.floor(xf).long(), lo, hi - lo


def splat(x: torch.Tensor, attr: torch.Tensor, shape: Tuple[int, ...],
          kernel: str = "bspline", support: float = 1.0) -> torch.Tensor:
    """Scatter particle attributes to a grid.

    Args:
      x: (N, dim) positions in cell-index coordinates (axis order).
      attr: (N,) or (N, C) per-particle values.
      shape: grid spatial shape, len == dim.
      kernel: 'linear' | 'bspline'.
      support: kernel dilation in cells; per-axis weights are divided by
        it, so the splat conserves mass for any dilation.

    Returns:
      (*shape,) or (*shape, C) grid; taps outside the grid are dropped.
    """
    with span("nfs.splat"):
        ndim = x.shape[-1]
        assert len(shape) == ndim
        has_channels = attr.ndim == 2
        xf = x.to(torch.float32)
        base, lo, taps = _base_and_stencil(xf, kernel, support)
        n_cells = math.prod(shape)
        inv_s = 1.0 / support
        n = x.shape[0]
        flat_idxs, flat_vals = [], []
        for offsets in itertools.product(range(lo, lo + taps), repeat=ndim):
            w = torch.ones(n, dtype=attr.dtype, device=x.device)
            flat = torch.zeros(n, dtype=torch.long, device=x.device)
            ok = torch.ones(n, dtype=torch.bool, device=x.device)
            for d in range(ndim):
                node = base[:, d] + offsets[d]
                u = (node.to(torch.float32) - xf[:, d]) * inv_s
                w = w * (_kernel_weight_1d(u, kernel) * inv_s).to(attr.dtype)
                ok = ok & (node >= 0) & (node < shape[d])
                flat = flat * shape[d] + node.clamp(0, shape[d] - 1)
            flat_idxs.append(torch.where(ok, flat, n_cells))  # sentinel row
            flat_vals.append(w[:, None] * attr if has_channels else w * attr)
        chans = (attr.shape[-1],) if has_channels else ()
        grid = torch.zeros((n_cells + 1,) + chans, dtype=attr.dtype,
                           device=x.device)
        grid = grid.index_add(0, torch.cat(flat_idxs), torch.cat(flat_vals))
        return grid[:n_cells].reshape(tuple(shape) + chans)


def splat_normalized(x: torch.Tensor, attr: torch.Tensor,
                     shape: Tuple[int, ...], kernel: str = "bspline",
                     support: float = 1.0, eps: float = 1e-6
                     ) -> torch.Tensor:
    """Weight-normalized splat: the grid holds the kernel-weighted
    *average* attribute (for intensive quantities like color)."""
    ones = torch.ones(x.shape[0], dtype=attr.dtype, device=x.device)
    num = splat(x, attr, shape, kernel=kernel, support=support)
    den = splat(x, ones, shape, kernel=kernel, support=support)
    if attr.ndim == 2:
        den = den[..., None]
    return num / (den + eps)


def gather(grid: torch.Tensor, x: torch.Tensor, kernel: str = "bspline",
           support: float = 1.0) -> torch.Tensor:
    """Grid-to-particle interpolation with the same kernel family. Weights
    are NOT divided by support (an intensive field) and are normalized by
    their sum; taps outside the grid read the clamped edge value."""
    ndim = x.shape[-1]
    shape = grid.shape[:ndim]
    has_channels = grid.ndim > ndim
    xf = x.to(torch.float32)
    base, lo, taps = _base_and_stencil(xf, kernel, support)
    inv_s = 1.0 / support
    out = wsum = None
    for offsets in itertools.product(range(lo, lo + taps), repeat=ndim):
        idx = []
        w = torch.ones(x.shape[0], dtype=grid.dtype, device=x.device)
        for d in range(ndim):
            node = base[:, d] + offsets[d]
            u = (node.to(torch.float32) - xf[:, d]) * inv_s
            w = w * _kernel_weight_1d(u, kernel).to(grid.dtype)
            idx.append(node.clamp(0, shape[d] - 1))
        vals = grid[tuple(idx)]
        term = w[:, None] * vals if has_channels else w * vals
        out = term if out is None else out + term
        wsum = w if wsum is None else wsum + w
    if has_channels:
        wsum = wsum[:, None]
    return out / (wsum + 1e-8)
