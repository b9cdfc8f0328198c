"""Multilinear grid sampling (counterpart of ``nfs_tpu/ops/interp.py``).

``grid_sample(field, coords)`` evaluates a field at fractional index
coordinates with bi/trilinear interpolation, differentiable in the field
and in the coordinates. The JAX package gives it a custom VJP, and
:class:`_GridSample` writes the same one out:

  - grad wrt coords: the 2^ndim corner values times the derivative of the
    lerp weights (+-1 along the axis, the other weights beside it);
  - grad wrt field: ONE ``index_add`` of all corner contributions. In
    'zero' mode corners outside the grid are dropped; in 'clamp' mode
    they land on the clamped edge cell, where the forward read them.

It is not ``torch.nn.functional.grid_sample``: that takes normalised
coordinates in reversed axis order and its gradients differ at the
clamped border.
"""

from __future__ import annotations

import itertools
import math

import torch


def _corner_gather(field, lo, corner, spatial_shape, mode):
    """Field values at the integer corner ``lo + corner``; outside the grid
    they read the clamped edge ('clamp') or 0 ('zero')."""
    idx = []
    inside = None
    for d, n in enumerate(spatial_shape):
        i = lo[..., d] + corner[d]
        if mode == "zero":
            ok = (i >= 0) & (i <= n - 1)
            inside = ok if inside is None else inside & ok
        idx.append(i.clamp(0, n - 1))
    vals = field[tuple(idx)]
    if mode == "zero":
        mask = inside if vals.ndim == inside.ndim else inside[..., None]
        vals = torch.where(mask, vals, 0.0)
    return vals


def _floor_frac(coords):
    lo_f = torch.floor(coords)
    return lo_f.long(), coords - lo_f


def _sample(field, coords, mode):
    ndim = coords.shape[-1]
    spatial_shape = field.shape[:ndim]
    has_channels = field.ndim > ndim
    lo, frac = _floor_frac(coords)
    out = None
    for corner in itertools.product((0, 1), repeat=ndim):
        w = torch.ones(coords.shape[:-1], dtype=field.dtype,
                       device=field.device)
        for d in range(ndim):
            w = w * (frac[..., d] if corner[d] else 1.0 - frac[..., d])
        vals = _corner_gather(field, lo, corner, spatial_shape, mode)
        term = (w[..., None] if has_channels else w) * vals
        out = term if out is None else out + term
    return out


class _GridSample(torch.autograd.Function):
    """The JAX package's custom VJP of ``_grid_sample_impl``."""

    @staticmethod
    def forward(ctx, field, coords, mode):
        coords32 = coords.to(torch.float32)
        ctx.save_for_backward(field, coords32)
        ctx.mode = mode
        ctx.coords_dtype = coords.dtype
        return _sample(field, coords32, mode)

    @staticmethod
    def backward(ctx, g):
        field, coords = ctx.saved_tensors
        mode = ctx.mode
        ndim = coords.shape[-1]
        spatial_shape = field.shape[:ndim]
        has_channels = field.ndim > ndim
        n_ch = field.shape[-1] if has_channels else 1
        n_cells = math.prod(spatial_shape)
        lo, frac = _floor_frac(coords)
        batch = coords.shape[:-1]

        grad_coords = torch.zeros_like(coords)
        g_rows = g.reshape(-1, n_ch)
        flat_idxs, flat_vals = [], []
        for corner in itertools.product((0, 1), repeat=ndim):
            w_ax = [frac[..., d] if corner[d] else 1.0 - frac[..., d]
                    for d in range(ndim)]
            # grad wrt field: this corner's rows of the one index_add
            w_all = torch.ones(batch, dtype=field.dtype, device=field.device)
            flat = torch.zeros(batch, dtype=torch.long, device=field.device)
            ok = torch.ones(batch, dtype=torch.bool, device=field.device)
            for d, n in enumerate(spatial_shape):
                w_all = w_all * w_ax[d]
                i = lo[..., d] + corner[d]
                ok = ok & (i >= 0) & (i <= n - 1)
                flat = flat * n + i.clamp(0, n - 1)
            if mode == "zero":  # outside corners contributed nothing
                flat = torch.where(ok, flat, n_cells)
            flat_idxs.append(flat.reshape(-1))
            flat_vals.append((w_all.reshape(-1)[:, None] * g_rows
                              ).to(field.dtype))
            # grad wrt coords
            vals = _corner_gather(field, lo, corner, spatial_shape, mode)
            gv = g * vals
            gv_sum = gv.sum(dim=-1) if has_channels else gv
            for d in range(ndim):
                dw = torch.ones(batch, dtype=torch.float32,
                                device=field.device)
                for d2 in range(ndim):
                    if d2 == d:
                        dw = dw * (1.0 if corner[d2] else -1.0)
                    else:
                        dw = dw * w_ax[d2]
                grad_coords[..., d] += dw * gv_sum.to(torch.float32)

        gf = torch.zeros((n_cells + 1, n_ch), dtype=field.dtype,
                         device=field.device)
        gf = gf.index_add(0, torch.cat(flat_idxs), torch.cat(flat_vals))
        gf = gf[:n_cells]
        grad_field = (gf.reshape(spatial_shape + (n_ch,)) if has_channels
                      else gf[:, 0].reshape(spatial_shape))
        return grad_field, grad_coords.to(ctx.coords_dtype), None


def grid_sample(field: torch.Tensor, coords: torch.Tensor,
                mode: str = "clamp") -> torch.Tensor:
    """Sample `field` at fractional index coordinates.

    Args:
      field: ``(*spatial)`` or ``(*spatial, C)`` tensor.
      coords: ``(..., ndim)`` fractional indices in **array-axis order**
        (coords[..., k] indexes field axis k).
      mode: 'clamp' (border replicate) or 'zero' (outside = 0).

    Returns:
      ``(...,)`` or ``(..., C)`` interpolated values.
    """
    if mode not in ("clamp", "zero"):
        raise ValueError(f"unknown boundary mode {mode!r}; "
                         "expected 'clamp' or 'zero'")
    return _GridSample.apply(field, coords, mode)


def identity_coords(shape, device="cpu") -> torch.Tensor:
    """(*shape, ndim) tensor of integer index coordinates (axis order)."""
    axes = [torch.arange(s, dtype=torch.float32, device=device)
            for s in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
