"""Shear-decomposed volume rotation (counterpart of
``nfs_tpu/ops/shear.py``).

A rotation in a plane is three 1D shears (Paeth/Tanaka):

    R(t) = Shear_u(-tan(t/2)) . Shear_v(sin t) . Shear_u(-tan(t/2))

and a 1D shear with linear interpolation is, per slice along the drive
axis, a banded ``(S, S)`` translation matrix applied along the move axis.
All slices of all views are one ``torch.bmm``; the volume gradient is the
transposed product. The view angles only build the matrices and get no
gradient.
"""

from __future__ import annotations

from typing import Optional

import torch


def _shear_matrix(size: int, drive_size: int, slope: torch.Tensor,
                  center_drive: float) -> torch.Tensor:
    """``(*slope.shape, drive_size, size, size)`` bank of 1D
    translation-interp matrices: row b pulls back out[i] = in(i - s_b),
    s_b = slope * (b - center_drive), i.e.
    T[b, i, j] = max(0, 1 - |i - s_b - j|)."""
    dev = slope.device
    b = (torch.arange(drive_size, dtype=torch.float32, device=dev)
         - center_drive)
    s = slope[..., None] * b                                   # (*, B)
    i = torch.arange(size, dtype=torch.float32, device=dev)
    diff = ((i[:, None] - s[..., None, None]) - i[None, :])    # (*, B, S, S)
    return torch.clamp(1.0 - diff.abs(), min=0.0)


def _as_operand(x: torch.Tensor, dtype) -> torch.Tensor:
    """bf16 operands with f32 accumulation, as the JAX package's einsum
    with ``preferred_element_type=f32``: the operands are rounded to bf16
    and the product runs in f32, so it is exact per product."""
    if dtype is None:
        return x
    return x.to(dtype).to(torch.float32)


def _shear_views(vol: torch.Tensor, move_axis: int, drive_axis: int,
                 slope: torch.Tensor, dtype=None) -> torch.Tensor:
    """Shear a batch of volumes ``(V, D, H, W)``, one slope per view;
    axes are those of one volume (0, 1, 2)."""
    V = vol.shape[0]
    size = vol.shape[1 + move_axis]
    drive_size = vol.shape[1 + drive_axis]
    t = _shear_matrix(size, drive_size, slope, (drive_size - 1) / 2.0)
    other_axis = 3 - move_axis - drive_axis
    perm = (0, 1 + drive_axis, 1 + move_axis, 1 + other_axis)
    v = vol.permute(perm)                                       # (V,B,S,O)
    O = v.shape[-1]
    out = torch.bmm(_as_operand(t, dtype).reshape(V * drive_size, size, size),
                    _as_operand(v, dtype).reshape(V * drive_size, size, O))
    out = out.view(V, drive_size, size, O)
    inv = [0] * 4
    for newpos, oldpos in enumerate(perm):
        inv[oldpos] = newpos
    return out.permute(inv)


def shear(vol: torch.Tensor, move_axis: int, drive_axis: int,
          slope, dtype=None) -> torch.Tensor:
    """Pull-back shear of a 3D volume: out[x] = vol at
    x_move - slope * (x_drive - c_drive), linear interpolation, zero
    boundary. ``dtype=torch.bfloat16`` rounds the operands to bf16."""
    if vol.ndim != 3 or move_axis == drive_axis:
        raise ValueError("shear takes a 3D volume and two distinct axes")
    slope = torch.as_tensor(slope, dtype=torch.float32,
                            device=vol.device).reshape(1)
    return _shear_views(vol[None], move_axis, drive_axis, slope, dtype)[0]


def _rotate_plane(vol: torch.Tensor, axis_u: int, axis_v: int,
                  angle: torch.Tensor, dtype=None) -> torch.Tensor:
    """Pull-back rotation by `angle` (one per view) in the (u, v) plane
    via three shears."""
    a = -torch.tan(angle / 2.0)
    b = torch.sin(angle)
    vol = _shear_views(vol, axis_u, axis_v, a, dtype)
    vol = _shear_views(vol, axis_v, axis_u, b, dtype)
    vol = _shear_views(vol, axis_u, axis_v, a, dtype)
    return vol


def rotate3d_shear(d: torch.Tensor, theta, phi,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Shear-decomposed rotation of a ``(D, H, W)`` volume (z, y, x):
    theta = azimuth about y (mixes z, x) applied first, then phi =
    elevation about x (mixes z, y). Scalar angles give ``(D, H, W)``;
    1-D angle tensors of V views give ``(V, D, H, W)``.
    ``dtype=torch.bfloat16`` is the 'shear_bf16' rotation."""
    theta = torch.as_tensor(theta, dtype=torch.float32, device=d.device)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=d.device)
    single = theta.ndim == 0
    theta, phi = theta.reshape(-1), phi.reshape(-1)
    vol = d[None].expand(theta.shape[0], *d.shape)
    out = _rotate_plane(vol, 0, 2, theta, dtype)   # y: (z, x) plane
    out = _rotate_plane(out, 0, 1, phi, dtype)     # x: (z, y) plane
    return out[0] if single else out
