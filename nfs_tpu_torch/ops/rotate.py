"""3D rotation resampling for view changes (counterpart of
``nfs_tpu/ops/rotate.py``; the renderer's ``rotation='gather'``).

``rotate3d(d, theta, phi)`` resamples the volume so that integrating the
result along axis 0 (z, depth) gives the view from azimuth ``theta``
(about the vertical y axis) and elevation ``phi`` (about the x axis):
out(x) = d(c + R^T (x - c)), trilinear, zero outside the volume.

The resample is the port's :func:`nfs_tpu_torch.ops.interp.grid_sample`,
which carries the JAX package's custom VJP, not
``torch.nn.functional.grid_sample`` (normalised coordinates, reversed
axes, other gradients at the border). It is differentiable in the volume
and, through the sample coordinates, in the angles.
"""

from __future__ import annotations

import functools

import torch

from nfs_tpu_torch.ops.interp import grid_sample, identity_coords


def rotation_matrix(theta, phi) -> torch.Tensor:
    """World rotation R = R_phi @ R_theta in (z, y, x) array-axis
    coordinates: theta about the y axis (mixes z and x), phi about the x
    axis (mixes z and y). Angle tensors of shape (...) give (..., 3, 3)."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=theta.device)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(phi), torch.sin(phi)
    zero, one = torch.zeros_like(ct), torch.ones_like(ct)
    r_theta = torch.stack([torch.stack([ct, zero, -st], -1),
                           torch.stack([zero, one, zero], -1),
                           torch.stack([st, zero, ct], -1)], -2)
    r_phi = torch.stack([torch.stack([cp, -sp, zero], -1),
                         torch.stack([sp, cp, zero], -1),
                         torch.stack([zero, zero, one], -1)], -2)
    return r_phi @ r_theta


@functools.lru_cache(maxsize=None)
def _center(shape, device: torch.device) -> torch.Tensor:
    """The volume's centre (z, y, x) in float32, built once per shape and
    device: building it on a GPU copies from the host, which waits for
    the device and cannot be captured in a CUDA graph."""
    return torch.tensor([(s - 1) / 2.0 for s in shape], dtype=torch.float32,
                        device=device)


def rotate3d_batch(d: torch.Tensor, thetas, phis,
                   mode: str = "zero") -> torch.Tensor:
    """Resample a (D, H, W) volume under V view rotations ->
    (V, D, H, W); the V resamples are one ``grid_sample`` call."""
    shape = tuple(d.shape[:3])
    thetas = torch.as_tensor(thetas, dtype=torch.float32, device=d.device)
    phis = torch.as_tensor(phis, dtype=torch.float32, device=d.device)
    center = _center(shape, d.device)
    r = rotation_matrix(thetas.reshape(-1), phis.reshape(-1))   # (V, 3, 3)
    coords = identity_coords(shape, device=d.device) - center
    # (x - c) @ R == R^T (x - c): the inverse rotation, per view
    src = coords[None] @ r[:, None, None] + center
    return grid_sample(d, src, mode=mode)


def rotate3d(d: torch.Tensor, theta, phi, mode: str = "zero"
             ) -> torch.Tensor:
    """Resample volume ``d`` (D, H, W) under one view rotation (scalar
    theta, phi, radians); samples outside the volume are zero by default
    (smoke floating in a dark background)."""
    return rotate3d_batch(d, torch.as_tensor(theta).reshape(1),
                          torch.as_tensor(phi).reshape(1), mode=mode)[0]
