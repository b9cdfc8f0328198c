"""Semi-Lagrangian advection (counterpart of ``nfs_tpu/ops/advect.py``).

``advect(field, vel)`` backtraces each cell centre by the velocity and
samples the field there: ``out(x) = field(x - dt * v(x))``, differentiable
in both ``field`` and ``vel``. Only the bounded-displacement (window)
formulation is ported: displacements are clamped to ``+-max_disp`` cells.

Backends, as in the JAX package:

- 3D clamp-mode fields go through :class:`AdvectWindow`, i.e. the CUDA
  kernels K1-K3 on a CUDA tensor and their plain twins on a CPU tensor
  (``nfs_tpu_torch/ops/advect_kernels.py``). A channelled 3D field, such
  as the velocity parameter, goes through K1 once per channel.
- 2D fields, ``mode='zero'`` and ``impl='xla'`` take
  :func:`_advect_window_taps`, the port of the JAX window-tap sum. Its
  tent and clip carry JAX's subgradients (abs'(0) = +1, 0.5 at ties), which
  torch's own ``abs`` and ``clamp`` do not.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from nfs_tpu_torch.ops.advect_kernels import (
    AdvectWindow, _clip_grad, _dtent, _tent)

_IMPLS = ("auto", "xla", "pallas")


class _JaxTent(torch.autograd.Function):
    """max(0, 1 - |u|) with JAX's subgradient (pallas_advect.py _dtent)."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return _tent(u)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return g * _dtent(u)


class _JaxClip(torch.autograd.Function):
    """clip(x, lo, hi) whose gradient is 0.5 at a bound, as jnp.clip's."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _clip_grad(x, *ctx.bounds), None, None


def _shift_zero(x: torch.Tensor, offsets, ndim_space: int) -> torch.Tensor:
    """out[i] = x[i + o] with zero fill outside (spatial axes only)."""
    sl = []
    pads = []
    for ax, o in enumerate(offsets):
        lo, hi = max(-o, 0), max(o, 0)
        pads.append((lo, hi))
        sl.append(slice(lo + o, lo + o + x.shape[ax]))
    # F.pad takes (last-axis-lo, last-axis-hi, ...) pairs
    flat = [0, 0] * (x.ndim - ndim_space)
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(x, flat)[tuple(sl)]


def _advect_window_taps(field: torch.Tensor, vel: torch.Tensor, dt: float,
                        mode: str, max_disp: float) -> torch.Tensor:
    """Window-tap sum of the JAX package's ``_advect_window``: the
    (2K+1)^ndim static shifts of the field with per-cell tent weights,
    K = ceil(max_disp) + 1, for 2D or 3D fields with optional trailing
    channels."""
    ndim = vel.shape[-1]
    spatial = tuple(field.shape[:ndim])
    K = int(math.ceil(max_disp)) + 1
    disp = _JaxClip.apply(dt * vel.to(torch.float32), -max_disp, max_disp)
    idx = []
    for a in range(ndim):
        view = [1] * ndim
        view[a] = spatial[a]
        idx.append(torch.arange(spatial[a], dtype=torch.float32,
                                device=field.device).view(view)
                   .expand(spatial))
    if mode == "clamp":
        s = [_JaxClip.apply(idx[a] - disp[..., a], 0.0, spatial[a] - 1)
             for a in range(ndim)]
    elif mode == "zero":  # raw backtrace; outside support falls to zero
        s = [idx[a] - disp[..., a] for a in range(ndim)]
    else:
        raise ValueError(f"unknown advection mode {mode!r}")
    weights = [[_JaxTent.apply(s[a] - (idx[a] + o)) for o in range(-K, K + 1)]
               for a in range(ndim)]
    has_channels = field.ndim > ndim
    acc = torch.zeros_like(field)
    for off in itertools.product(range(-K, K + 1), repeat=ndim):
        w = weights[0][off[0] + K]
        for a in range(1, ndim):
            w = w * weights[a][off[a] + K]
        if has_channels:
            w = w[..., None]
        acc = acc + w * _shift_zero(field, off, ndim)
    return acc


def _advect_window(field: torch.Tensor, vel: torch.Tensor, dt: float,
                   mode: str, max_disp: float) -> torch.Tensor:
    """Bounded-displacement advection on the fastest backend: the K1-K3
    path for 3D clamp-mode fields (per channel for a channelled field),
    the window-tap sum otherwise."""
    if vel.shape[-1] == 3 and mode == "clamp" and field.ndim in (3, 4):
        v = vel.to(torch.float32) * dt
        if field.ndim == 3:
            return AdvectWindow.apply(field, v, max_disp)
        return torch.stack([AdvectWindow.apply(field[..., c], v, max_disp)
                            for c in range(field.shape[-1])], dim=-1)
    return _advect_window_taps(field, vel, dt, mode, max_disp)


def advect(field: torch.Tensor, vel: torch.Tensor, dt: float = 1.0,
           mode: str = "clamp", max_disp: Optional[float] = None,
           impl: str = "auto") -> torch.Tensor:
    """Semi-Lagrangian advection.

    Args:
      field: ``(*spatial)`` or ``(*spatial, C)``.
      vel: ``(*spatial, ndim)``, channel i = cells/frame along array axis i.
      dt: timestep in frames (negative to advect backwards).
      mode: 'clamp' or 'zero' boundary.
      max_disp: bound on the displacement (cells); required.
      impl: 'auto' = K1-K3 for 3D clamp-mode fields, as the JAX package
        picks its Pallas kernels there; 'pallas' (the config keeps the JAX
        package's name) also checks that the field is a 3D scalar
        clamp-mode one; 'xla' forces the window-tap sum.
    """
    if max_disp is None:
        raise NotImplementedError(
            "advect with max_disp=None (the exact grid_sample path, "
            "ops/interp.py) is not ported yet: ROADMAP queue 1, item 12")
    if impl not in _IMPLS:
        raise ValueError(f"unknown advect impl {impl!r}")
    if impl == "xla":
        return _advect_window_taps(field, vel, dt, mode, max_disp)
    if impl == "pallas" and not (
            field.ndim == 3 and mode == "clamp"
            and tuple(vel.shape) == tuple(field.shape) + (3,)):
        raise ValueError(
            "impl='pallas' supports 3D scalar clamp-mode fields")
    return _advect_window(field, vel, dt, mode, max_disp)


def _pool_minmax(field: torch.Tensor, radius: int,
                 spatial_ndim: Optional[int] = None):
    """(min, max) over a (2*radius+1)**d spatial neighbourhood (out-of-grid
    cells excluded); a trailing channel axis is pooled per channel."""
    ndim = field.ndim if spatial_ndim is None else spatial_ndim
    pool = {2: F.max_pool2d, 3: F.max_pool3d}[ndim]
    chans = field.ndim > ndim
    # (1, C, *spatial) for the pooling op
    x = (field.movedim(-1, 0) if chans else field[None])[None]
    k = 2 * radius + 1

    def maxpool(t):
        out = pool(t, kernel_size=k, stride=1, padding=radius)[0]
        return out.movedim(0, -1) if chans else out[0]

    return -maxpool(-x), maxpool(x)


def advect_maccormack(field: torch.Tensor, vel: torch.Tensor,
                      dt: float = 1.0, mode: str = "clamp",
                      max_disp: Optional[float] = None) -> torch.Tensor:
    """MacCormack/BFECC advection with min-max limiting:
    fwd = SL(field, v, dt); bwd = SL(fwd, v, -dt);
    out = clip(fwd + 0.5 * (field - bwd), local min, local max), the
    limiter pooling over the displacement neighbourhood."""
    if max_disp is None:
        raise NotImplementedError(
            "advect_maccormack with max_disp=None (the exact grid_sample "
            "path) is not ported yet: ROADMAP queue 1, item 12")
    ndim = vel.shape[-1]
    fwd = _advect_window(field, vel, dt, mode, max_disp)
    bwd = _advect_window(fwd, vel, -dt, mode, max_disp)
    out = fwd + 0.5 * (field - bwd)
    mins, maxs = _pool_minmax(field, int(math.ceil(max_disp)) + 1,
                              spatial_ndim=ndim)
    return torch.minimum(torch.maximum(out, mins), maxs)

