"""Semi-Lagrangian advection (counterpart of ``nfs_tpu/ops/advect.py``).

``advect(field, vel)`` backtraces each cell centre by the velocity and
samples the field there: ``out(x) = field(x - dt * v(x))``, differentiable
in both ``field`` and ``vel``. With ``max_disp=None`` it takes the exact
path: one multilinear sample at the backtrace (``ops/interp.grid_sample``,
a gather forward and one ``index_add`` for the field gradient), for any
displacement. In clamp mode that path clamps the corner indices to the
grid, while the window path clamps the backtrace coordinates, so the two
differ at the boundary by design.

With ``max_disp`` set, displacements are clamped to ``+-max_disp`` cells,
on the backends the JAX package picks:

- 3D clamp-mode fields go through :class:`AdvectWindow`, i.e. the CUDA
  kernels K1-K3b on a CUDA tensor and their plain twins on a CPU tensor
  (``nfs_tpu_torch/ops/advect_kernels.py``). A channelled 3D field, such
  as the velocity parameter, goes through K1 once per channel.
- 2D fields, ``mode='zero'`` and ``impl='xla'`` take
  :func:`_advect_window_taps`, the port of the JAX window-tap sum. Its
  tent and clip carry JAX's subgradients (abs'(0) = +1, 0.5 at ties), which
  torch's own ``abs`` and ``clamp`` do not.

:func:`advect_frames` advects a batch of frames, each by its own
velocity; on the K1-K3b path the whole batch is one launch per kernel.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from nfs_tpu_torch.ops.advect_kernels import AdvectWindow
from nfs_tpu_torch.ops.interp import grid_sample, identity_coords
from nfs_tpu_torch.ops.jaxgrad import jax_clip, jax_tent

_IMPLS = ("auto", "xla", "pallas")


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
                        mode: str, max_disp: float,
                        origin=None) -> torch.Tensor:
    """Window-tap sum of the JAX package's ``_advect_window``: the
    (2K+1)^ndim static shifts of the field with per-cell tent weights,
    K = ceil(max_disp) + 1, for 2D or 3D fields with optional trailing
    channels. ``origin = (axis, offset)``: the field is a slab whose cell
    i along ``axis`` is the volume's ``i + offset``; the backtrace is
    taken in the volume's indices, so it rounds as the volume's does."""
    ndim = vel.shape[-1]
    spatial = tuple(field.shape[:ndim])
    K = int(math.ceil(max_disp)) + 1
    disp = jax_clip(dt * vel.to(torch.float32), -max_disp, max_disp)
    lo = [0] * ndim
    if origin is not None:
        lo[origin[0]] = origin[1]
    idx = []
    for a in range(ndim):
        view = [1] * ndim
        view[a] = spatial[a]
        idx.append((torch.arange(spatial[a], dtype=torch.float32,
                                 device=field.device) + lo[a]).view(view)
                   .expand(spatial))
    if mode == "clamp":
        s = [jax_clip(idx[a] - disp[..., a], lo[a], lo[a] + spatial[a] - 1)
             for a in range(ndim)]
    elif mode == "zero":  # raw backtrace; outside support falls to zero
        s = [idx[a] - disp[..., a] for a in range(ndim)]
    else:
        raise ValueError(f"unknown advection mode {mode!r}")
    weights = [[jax_tent(s[a] - (idx[a] + o)) for o in range(-K, K + 1)]
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
                   mode: str, max_disp: float, batched: bool = False,
                   origin=None) -> torch.Tensor:
    """Bounded-displacement advection on the fastest backend: the K1-K3
    path for 3D clamp-mode fields (per channel for a channelled field),
    the window-tap sum otherwise. ``batched``: field and vel carry a
    leading frame axis, which the K1-K3 path takes in one launch and the
    window-tap sum frame by frame. ``origin``: as :func:`advect`'s."""
    spatial_ndim = field.ndim - int(batched)
    if vel.shape[-1] == 3 and mode == "clamp" and spatial_ndim in (3, 4):
        v = vel.to(torch.float32) * dt
        if spatial_ndim == 3:
            return AdvectWindow.apply(field, v, max_disp, origin)
        return torch.stack([AdvectWindow.apply(field[..., c], v, max_disp,
                                               origin)
                            for c in range(field.shape[-1])], dim=-1)
    if batched:
        return torch.stack([_advect_window_taps(f, u, dt, mode, max_disp,
                                                origin)
                            for f, u in zip(field, vel)])
    return _advect_window_taps(field, vel, dt, mode, max_disp, origin)


def advect(field: torch.Tensor, vel: torch.Tensor, dt: float = 1.0,
           mode: str = "clamp", max_disp: Optional[float] = None,
           impl: str = "auto", origin=None) -> torch.Tensor:
    """Semi-Lagrangian advection.

    Args:
      field: ``(*spatial)`` or ``(*spatial, C)``.
      vel: ``(*spatial, ndim)``, channel i = cells/frame along array axis i.
      dt: timestep in frames (negative to advect backwards).
      mode: 'clamp' or 'zero' boundary.
      max_disp: bound on the displacement (cells); None = the exact
        gather path (any displacement).
      impl: window-path backend. 'auto' = K1-K3 for 3D clamp-mode fields,
        as the JAX package picks its Pallas kernels there; 'pallas' (the
        config keeps the JAX package's name) also checks that the field
        is a 3D scalar clamp-mode one; 'xla' forces the window-tap sum.
      origin: window path only: ``(axis, offset)`` when ``field`` and
        ``vel`` are a slab of a volume whose cell i along spatial ``axis``
        is the volume's ``i + offset`` (``parallel/spatial.py``); each
        output cell whose backtrace stays inside the slab is then the
        volume's, bit for bit.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown advect impl {impl!r}")
    if max_disp is None:
        out = grid_sample(field, _backtrace(vel, dt, field.device),
                          mode=mode)
        return out.to(field.dtype)
    if impl == "xla":
        return _advect_window_taps(field, vel, dt, mode, max_disp, origin)
    if impl == "pallas" and not (
            field.ndim == 3 and mode == "clamp"
            and tuple(vel.shape) == tuple(field.shape) + (3,)):
        raise ValueError(
            "impl='pallas' supports 3D scalar clamp-mode fields")
    return _advect_window(field, vel, dt, mode, max_disp, origin=origin)


def advect_frames(fields: torch.Tensor, vels: torch.Tensor, dt: float = 1.0,
                  mode: str = "clamp", max_disp: Optional[float] = None,
                  impl: str = "auto", origin=None) -> torch.Tensor:
    """:func:`advect` over a batch of frames: ``fields`` (B, *spatial) or
    (B, *spatial, C), ``vels`` (B, *spatial, ndim), frame b advected by
    ``vels[b]``. On the window path a 3D clamp-mode batch goes through
    K1-K3b with one launch per kernel for all B frames (per channel for a
    channelled field); every other case runs :func:`advect` frame by
    frame. ``origin``: as :func:`advect`'s, for every frame."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown advect impl {impl!r}")
    if max_disp is None or impl == "xla" or (
            impl == "pallas" and not (
                fields.ndim == 4 and mode == "clamp"
                and tuple(vels.shape) == tuple(fields.shape) + (3,))):
        return torch.stack([advect(f, v, dt, mode, max_disp, impl, origin)
                            for f, v in zip(fields, vels)])
    return _advect_window(fields, vels, dt, mode, max_disp, batched=True,
                          origin=origin)


def _backtrace(vel: torch.Tensor, dt: float, device) -> torch.Tensor:
    """Exact-path sample coordinates x - dt * v(x), (*spatial, ndim)."""
    return (identity_coords(tuple(vel.shape[:-1]), device=device)
            - dt * vel.to(torch.float32))


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
    out = clip(fwd + 0.5 * (field - bwd), local min, local max).

    With ``max_disp`` set the limiter pools over the displacement
    neighbourhood; with None (the exact path) it takes the 2^ndim cells
    around the backtraced point, their indices clamped to the grid. The
    clip is ``minimum(maximum(out, mins), maxs)``, whose gradient splits
    0.5/0.5 at a tie as ``jnp.clip``'s does; through the gathered corners
    part of it reaches ``field``."""
    ndim = vel.shape[-1]
    if max_disp is not None:
        fwd = _advect_window(field, vel, dt, mode, max_disp)
        bwd = _advect_window(fwd, vel, -dt, mode, max_disp)
        mins, maxs = _pool_minmax(field, int(math.ceil(max_disp)) + 1,
                                  spatial_ndim=ndim)
    else:
        coords = _backtrace(vel, dt, field.device)
        fwd = grid_sample(field, coords, mode=mode)
        bwd = grid_sample(fwd, _backtrace(vel, -dt, field.device),
                          mode=mode)
        lo = torch.floor(coords).long()
        spatial = tuple(vel.shape[:-1])
        mins = maxs = None
        for corner in itertools.product((0, 1), repeat=ndim):
            v = field[tuple((lo[..., d] + corner[d]).clamp(0, spatial[d] - 1)
                            for d in range(ndim))]
            mins = v if mins is None else torch.minimum(mins, v)
            maxs = v if maxs is None else torch.maximum(maxs, v)
    out = fwd + 0.5 * (field - bwd)
    return torch.minimum(torch.maximum(out, mins), maxs)


def advect_chain(field: torch.Tensor, vels: torch.Tensor, dt: float = 1.0,
                 mode: str = "clamp",
                 max_disp: Optional[float] = None) -> torch.Tensor:
    """Advect ``field`` through the velocity fields ``vels`` (T, *spatial,
    ndim) in order 0..T-1: the transport of the window loss (TNST §6)."""
    for v in vels:
        field = advect(field, v, dt=dt, mode=mode, max_disp=max_disp)
    return field
