"""Differentiable Beer-Lambert volume renderer (counterpart of
``nfs_tpu/render/raymarch.py``; TNST §5).

Per view: rotate the density volume to the view frame
(:func:`nfs_tpu_torch.ops.shear.rotate3d_shear`), then march along the
depth axis with front-to-back absorption compositing:

    C_t = sum_{s<t} rho_s                       (exclusive cumsum)
    I(u, v) = sum_t  sigma * rho_t * exp(-sigma * C_t)

All views of one volume are rotated and marched as one batch. With a
per-voxel colour (LNST colour, or a transfer function applied after the
rotation) the image is the density-weighted composite of the colour.

2D stylization renders the grid itself as the image (:func:`render2d`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nfs_tpu_torch.ops.jaxgrad import jax_clip, jax_maximum
from nfs_tpu_torch.ops.resize import resize_axes
from nfs_tpu_torch.ops.rotate import rotate3d_batch
from nfs_tpu_torch.ops.shear import rotate3d_shear, rotate3d_shear_volumes
from nfs_tpu_torch.render.transfer import transfer_colors
from nfs_tpu_torch.utils.profiling import span


def _exclusive_cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.cumsum(x, dim=axis) - x


def _rotate(d: torch.Tensor, theta, phi, method: str) -> torch.Tensor:
    """View rotation of a (D, H, W) volume: scalar angles give one
    volume, 1-D angle tensors a (V, D, H, W) batch. 'shear' is the
    three-shear GEMM path, 'gather' the exact trilinear resample."""
    if method == "shear":
        return rotate3d_shear(d, theta, phi)
    if method == "shear_bf16":
        return rotate3d_shear(d, theta, phi, dtype=torch.bfloat16)
    if method == "gather":
        theta = torch.as_tensor(theta, dtype=torch.float32, device=d.device)
        phi = torch.as_tensor(phi, dtype=torch.float32, device=d.device)
        out = rotate3d_batch(d, theta.reshape(-1), phi.reshape(-1),
                             mode="zero")
        return out[0] if theta.ndim == 0 else out
    raise ValueError(f"unknown rotation method {method!r}")


def _march(rho: torch.Tensor, transmit: float, axis: int,
           color: Optional[torch.Tensor] = None) -> torch.Tensor:
    rho = jax_maximum(rho, 0.0)
    trans = torch.exp(-transmit * _exclusive_cumsum(rho, axis))
    w = transmit * rho * trans
    if color is None:
        return torch.sum(w, dim=axis)
    return torch.sum(w[..., None] * color, dim=axis)


def raymarch(rho: torch.Tensor, transmit: float = 0.01, axis: int = 0,
             out_size: Optional[Tuple[int, int]] = None,
             color: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integrate a view-aligned ``(D, H, W)`` volume along `axis` to an
    (H, W) image, or with ``color`` (D, H, W, 3) to the density-weighted
    (H, W, 3) composite; resized (linear, antialiased) to ``out_size`` if
    given."""
    img = _march(rho, transmit, axis, color)
    if out_size is not None:
        img = resize_axes(img, (0, 1), tuple(out_size))
    return img


def _gamma(img: torch.Tensor, gamma: float) -> torch.Tensor:
    if gamma != 1.0:
        img = torch.pow(jax_maximum(img, 1e-6), 1.0 / gamma)
    return img


def render_volume(d: torch.Tensor, theta, phi, transmit: float = 0.01,
                  out_size: Optional[Tuple[int, int]] = None,
                  gamma: float = 1.0, method: str = "shear",
                  tf_nodes: Optional[torch.Tensor] = None,
                  tf_max: float = 1.0) -> torch.Tensor:
    """Render one view of a (D, H, W) volume: rotate (theta azimuth, phi
    elevation, radians), then march along z. (H, W) gray, or with
    ``tf_nodes`` (N, 3) an (H, W, 3) image whose colour is the transfer
    function of the rotated density."""
    with span("nfs.render"):
        rot = _rotate(d, theta, phi, method)
        color = (None if tf_nodes is None
                 else transfer_colors(rot, tf_nodes, tf_max))
        img = raymarch(rot, transmit=transmit, axis=0, out_size=out_size,
                       color=color)
        return _gamma(img, gamma)


def render_views(d: torch.Tensor, thetas: torch.Tensor, phis: torch.Tensor,
                 transmit: float = 0.01,
                 out_size: Optional[Tuple[int, int]] = None,
                 gamma: float = 1.0, method: str = "shear",
                 tf_nodes: Optional[torch.Tensor] = None,
                 tf_max: float = 1.0,
                 color: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render a batch of views -> (V, H, W, 3). Grayscale is tiled to
    three channels for the CNN; with ``tf_nodes`` the channels are the
    transfer function's colours, and with ``color`` (D, H, W, 3), a
    per-voxel colour volume rotated with the density, its composite."""
    with span("nfs.render"):
        rot = _rotate(d, thetas, phis, method)             # (V, D, H, W)
        col = None
        if color is not None:
            col = torch.stack([_rotate(color[..., c], thetas, phis, method)
                               for c in range(3)], dim=-1)
        return _composite(rot, transmit, out_size, gamma, tf_nodes, tf_max,
                          col)


def _composite(rot, transmit, out_size, gamma, tf_nodes, tf_max, col=None):
    """(V, H, W, 3) images of V view-aligned volumes (V, D, H, W)."""
    if col is None and tf_nodes is not None:
        col = transfer_colors(rot, tf_nodes, tf_max)
    img = _march(rot, transmit, axis=1, color=col)     # (V, H, W[, 3])
    if out_size is not None:
        img = resize_axes(img, (1, 2), tuple(out_size))
    img = _gamma(img, gamma)
    if col is not None:
        return img
    return img[..., None].expand(*img.shape, 3)


def render_views_batch(ds: torch.Tensor, thetas: torch.Tensor,
                       phis: torch.Tensor, transmit: float = 0.01,
                       out_size: Optional[Tuple[int, int]] = None,
                       gamma: float = 1.0, method: str = "shear",
                       tf_nodes: Optional[torch.Tensor] = None,
                       tf_max: float = 1.0) -> torch.Tensor:
    """:func:`render_views` of a batch of volumes ``ds`` (S, D, H, W),
    volume s under its own views ``thetas[s]``, ``phis[s]`` (S, V) ->
    (S, V, H', W', 3). The shear rotations render every view of every
    volume as one batch; 'gather' renders volume by volume."""
    with span("nfs.render"):
        S, V = thetas.shape
        if method not in ("shear", "shear_bf16"):
            return torch.stack([
                render_views(d, t, p, transmit=transmit, out_size=out_size,
                             gamma=gamma, method=method, tf_nodes=tf_nodes,
                             tf_max=tf_max)
                for d, t, p in zip(ds, thetas, phis)])
        vols = ds[:, None].expand(S, V, *ds.shape[1:]).reshape(
            S * V, *ds.shape[1:])
        rot = rotate3d_shear_volumes(
            vols, thetas.reshape(-1).to(torch.float32),
            phis.reshape(-1).to(torch.float32),
            torch.bfloat16 if method == "shear_bf16" else None)
        img = _composite(rot, transmit, out_size, gamma, tf_nodes, tf_max)
        return img.reshape(S, V, *img.shape[1:])


def render2d(d: torch.Tensor, out_size: Optional[Tuple[int, int]] = None,
             gamma: float = 1.0, color: Optional[torch.Tensor] = None,
             compress: str = "soft",
             tf_nodes: Optional[torch.Tensor] = None,
             tf_max: float = 1.0) -> torch.Tensor:
    """2D grid -> (H, W, 3) image; an optional (H, W, 3) colour field (or
    the transfer function ``tf_nodes`` of the density) is modulated by
    the density.

    compress: how density maps to [0, 1] brightness: 'soft' (default),
      1 - exp(-max(d, 0)), the 2D analogue of the Beer-Lambert
      transmittance, whose gradient never vanishes; 'clip', a hard clip
      to [0, 1]. Both keep JAX's subgradients at their ties (0.5 at
      d == 0 and at a clip bound).
    """
    with span("nfs.render"):
        if tf_nodes is not None:
            color = transfer_colors(d, tf_nodes, tf_max)
        if compress == "soft":
            img = 1.0 - torch.exp(-jax_maximum(d, 0.0))
        else:
            img = jax_clip(d, 0.0, 1.0)
        img = _gamma(img, gamma)
        if color is None:
            img = img[..., None].expand(*img.shape, 3)
        else:
            img = img[..., None] * jax_clip(color, 0.0, 1.0)
        if out_size is not None:
            img = resize_axes(img, (0, 1), tuple(out_size))
        return img
