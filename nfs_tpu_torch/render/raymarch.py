"""Differentiable Beer-Lambert volume renderer (counterpart of
``nfs_tpu/render/raymarch.py``; TNST §5).

Per view: rotate the density volume to the view frame
(:func:`nfs_tpu_torch.ops.shear.rotate3d_shear`), then march along the
depth axis with front-to-back absorption compositing:

    C_t = sum_{s<t} rho_s                       (exclusive cumsum)
    I(u, v) = sum_t  sigma * rho_t * exp(-sigma * C_t)

All views of one volume are rotated and marched as one batch. Colour
transfer functions and the 2D renderer are not ported yet (ROADMAP queue
1, items 15 and 6).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nfs_tpu_torch.ops.resize import resize_axes
from nfs_tpu_torch.ops.shear import rotate3d_shear


class _Maximum(torch.autograd.Function):
    """max(x, c) for a constant c whose gradient is 0.5 at a tie, as
    jnp.maximum's (torch's clamp gives 1). Densities are exactly 0 in much
    of a smoke volume, so the tie is common, not a corner case."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.save_for_backward(x)
        ctx.c = c
        return torch.clamp(x, min=c)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = torch.where(x > ctx.c, 1.0, torch.where(x == ctx.c, 0.5, 0.0))
        return g * w, None


def jax_maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    return _Maximum.apply(x, c)


def _exclusive_cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.cumsum(x, dim=axis) - x


def _rotate(d: torch.Tensor, theta, phi, method: str) -> torch.Tensor:
    if method == "shear":
        return rotate3d_shear(d, theta, phi)
    if method == "shear_bf16":
        return rotate3d_shear(d, theta, phi, dtype=torch.bfloat16)
    if method == "gather":
        raise NotImplementedError(
            "rotation='gather' (ops/rotate.py rotate3d) is not ported yet: "
            "ROADMAP queue 1, item 5")
    raise ValueError(f"unknown rotation method {method!r}")


def _march(rho: torch.Tensor, transmit: float, axis: int) -> torch.Tensor:
    rho = jax_maximum(rho, 0.0)
    trans = torch.exp(-transmit * _exclusive_cumsum(rho, axis))
    return torch.sum(transmit * rho * trans, dim=axis)


def raymarch(rho: torch.Tensor, transmit: float = 0.01, axis: int = 0,
             out_size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Integrate a view-aligned ``(D, H, W)`` volume along `axis` to an
    image, resized (linear, antialiased) to ``out_size`` if given.
    Per-voxel colour compositing (LNST colour) is not ported yet."""
    img = _march(rho, transmit, axis)
    if out_size is not None:
        img = resize_axes(img, (0, 1), tuple(out_size))
    return img


def _no_transfer(tf_nodes) -> None:
    if tf_nodes is not None:
        raise NotImplementedError(
            "transfer-function colour rendering (render/transfer.py) is not "
            "ported yet: ROADMAP queue 1, item 15")


def render_volume(d: torch.Tensor, theta, phi, transmit: float = 0.01,
                  out_size: Optional[Tuple[int, int]] = None,
                  gamma: float = 1.0, method: str = "shear",
                  tf_nodes=None) -> torch.Tensor:
    """Render one view of a (D, H, W) volume to an (H, W) gray image:
    rotate (theta azimuth, phi elevation, radians), then march along z."""
    _no_transfer(tf_nodes)
    rot = _rotate(d, theta, phi, method)
    img = raymarch(rot, transmit=transmit, axis=0, out_size=out_size)
    if gamma != 1.0:
        img = torch.pow(jax_maximum(img, 1e-6), 1.0 / gamma)
    return img


def render_views(d: torch.Tensor, thetas: torch.Tensor, phis: torch.Tensor,
                 transmit: float = 0.01,
                 out_size: Optional[Tuple[int, int]] = None,
                 gamma: float = 1.0, method: str = "shear",
                 tf_nodes=None) -> torch.Tensor:
    """Render a batch of views -> (V, H, W, 3), grayscale tiled to three
    channels for the CNN."""
    _no_transfer(tf_nodes)
    rot = _rotate(d, thetas, phis, method)             # (V, D, H, W)
    img = _march(rot, transmit, axis=1)                # (V, H, W)
    if out_size is not None:
        img = resize_axes(img, (1, 2), tuple(out_size))
    if gamma != 1.0:
        img = torch.pow(jax_maximum(img, 1e-6), 1.0 / gamma)
    return img[..., None].expand(*img.shape, 3)
