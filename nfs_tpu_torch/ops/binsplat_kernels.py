"""Binned-splat window kernels K4-K5, LNST's colour pair K4c-K5c, and
their plain versions.

Counterpart of ``nfs_tpu/ops/pallas_binsplat.py``. Two CUDA kernels in
``nfs_tpu_torch/csrc/binsplat.cu`` replace its two Pallas kernels; two
more run LNST's colour pass, which the JAX package leaves to XLA's
generic window (its Pallas kernels take one channel), so they replace no
TPU kernel:

=========  =======================================  ==================
launch     CUDA kernel (binsplat.cu)                replaces
=========  =======================================  ==================
fwd        ``binsplat_fwd_kernel``  (K4)            ``_fwd_kernel``
bwd        ``binsplat_bwd_kernel``  (K5)            ``_bwd_kernel``
color_fwd  ``binsplat_color_fwd_kernel``  (K4c)     none
color_bwd  ``binsplat_color_bwd_kernel``  (K5c)     none
=========  =======================================  ==================

Both work on four ``(K, Zp, Yp, Xp)`` float32 bin arrays over the padded
grid: the masked attribute ``a`` and the raw position components
``p_z, p_y, p_x`` (unpadded grid coordinates). :func:`binsplat_fwd`
returns the padded ``(Zp, Yp, Xp)`` splat, :func:`binsplat_bwd` the
gradients wrt the four arrays given the cotangent ``g`` of that splat.
A keyframe batch, ``(B, K, Zp, Yp, Xp)`` bins and a ``(B, Zp, Yp, Xp)``
splat, is one launch of each kernel with each keyframe's bits of a
single launch (the keyframe-parallel engine, ``parallel/particles.py``).
On a CPU tensor a wrapper runs its plain PyTorch version (``window_*_plain``);
on a CUDA tensor it launches the kernel and counts the launch in
:data:`LAUNCHES`, or raises. There is no fallback from CUDA to the plain
version.

The TPU path keeps its chunk state in a shifted, tile-rounded
``(K, Zp, Yb, Xb)`` layout (``prep_shifted``, ``window_shifted``,
``_pick_tz``) to meet the (8, 128) tiling and the VMEM budget. Here the
slot layout is rank-major, so ``attr_b[:n_slots]`` already views as
``(K, Zp, Yp, Xp)`` without a copy and that layout has no counterpart:
``binned_layout`` 'auto' and 'slots' both mean the slot layout.
:func:`splat_binned_window` is the drop-in for ``splat_binned_pallas``.

K4 gives each warp a row of output cells along x and each lane a column
of cells along z; a lane computes its own slot's weights once per row of
slots and passes them to the lanes beside it. It stages nothing in
shared memory, so its launch does not depend on K. K5 gives each warp a
run of consecutive slots: it writes the slots that no tap reaches (frac
outside (-1.5, 3.5) along some axis, whatever their positions) at once
and computes the others' sums, one slot a lane, from a list in shared
memory. ``binsplat.cu`` notes what bounds each kernel on the H100 and what the
design does about it.

K4c and K5c are K4 and K5 over five channels [density, colour clipped to
[0, 1], ones] (``splat_binned_color_window``, through
:class:`BinColorWindow`). They read the slot-minor binned arrays as the
styler holds them, positions ``(3, S)``, densities ``(S,)``, raw colours
``(3, S)`` and the dense slots' ``valid`` bytes, with a leading B for a
keyframe batch; the splat is ``(Z, Y, X, 5)`` on the unpadded grid. A
slot's weights serve all five channels, and the backward writes the
position, density and colour gradients of every slot in one launch (0
for slots that are not valid and for parked ones), with the clip's
subgradient applied; nothing per tap is kept for it.

The library is built with ``nvcc`` for ``sm_90a`` at first use. On
CUDA tensors each wrapper calls its operator ``torch.ops.nfs_tpu_torch``
(``csrc/ops.cpp``), which checks the tensors and launches on the current
stream in C++ (``ops/_cuda_build.py``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from nfs_tpu_torch.ops import _cuda_build
from nfs_tpu_torch.ops.advect_kernels import _clip_grad
from nfs_tpu_torch.ops.binsplat import PAD, padded_shape
from nfs_tpu_torch.utils.profiling import span

# Launch counts of the CUDA kernels; each wrapper adds one where it
# launches, and nowhere else.
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd": 0, "color_fwd": 0,
                            "color_bwd": 0}

SOURCE = _cuda_build.CSRC / "binsplat.cu"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_library() -> Path:
    """Compile binsplat.cu unless a library for this source exists."""
    return _cuda_build.build_library(SOURCE, "nfs_binsplat")


# Build (first use) and load the kernels and the operators that launch
# them; returns ``torch.ops.nfs_tpu_torch`` (ops/_cuda_build.py).
load_library = _cuda_build.load_operators


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #

def _w1d(u: torch.Tensor) -> torch.Tensor:
    """Quadratic B-spline (pallas_binsplat.py _w1d)."""
    au = u.abs()
    return torch.where(au < 0.5, 0.75 - au * au,
                       torch.where(au < 1.5, 0.5 * (1.5 - au) ** 2, 0.0))


def _dw1d(u: torch.Tensor) -> torch.Tensor:
    """d w1d / du with JAX's conventions: the branch the forward `where`
    takes at |u| = 0.5 and 1.5, and abs'(0) = +1 (pallas_binsplat.py
    _dw1d)."""
    sgn = torch.where(u >= 0.0, 1.0, -1.0)
    au = u.abs()
    return torch.where(au < 0.5, -2.0 * u,
                       torch.where(au < 1.5, -(1.5 - au) * sgn, 0.0))


def _fracs(pz, py, px):
    """frac_d = p_d + PAD - bin_d for every slot, (K, Zp, Yp, Xp) each."""
    _, Z, Y, X = pz.shape
    dev = pz.device
    f32 = torch.float32
    return (pz + float(PAD) - torch.arange(Z, dtype=f32, device=dev
                                           ).view(Z, 1, 1),
            py + float(PAD) - torch.arange(Y, dtype=f32, device=dev
                                           ).view(Y, 1),
            px + float(PAD) - torch.arange(X, dtype=f32, device=dev))


_OFFSETS = [(oz, oy, ox) for oz in range(3) for oy in range(3)
            for ox in range(3)]


def window_fwd_plain(a, pz, py, px) -> torch.Tensor:
    """K4 on tensors: out[q] = sum_k sum_off W_off[k, q - off] *
    a[k, q - off], as 27 shifted adds over the bin arrays; a keyframe
    batch keyframe by keyframe."""
    if a.ndim == 5:
        return torch.stack([window_fwd_plain(*t)
                            for t in zip(a, pz, py, px)])
    _, Z, Y, X = a.shape
    W = [[_w1d(float(o) - f) for o in range(3)] for f in _fracs(pz, py, px)]
    out = torch.zeros((Z, Y, X), dtype=torch.float32, device=a.device)
    for oz, oy, ox in _OFFSETS:
        contrib = (W[0][oz] * W[1][oy] * W[2][ox] * a).sum(dim=0)
        out[oz:, oy:, ox:] += contrib[:Z - oz, :Y - oy, :X - ox]
    return out


def window_bwd_plain(a, pz, py, px, g) -> Tuple[torch.Tensor, ...]:
    """K5 on tensors: (da, dp_z, dp_y, dp_x), each (K, Zp, Yp, Xp), with
    the cotangent read at g[b + off] (zero beyond the grid); a keyframe
    batch keyframe by keyframe."""
    if a.ndim == 5:
        return tuple(torch.stack(r) for r in zip(*(
            window_bwd_plain(*t) for t in zip(a, pz, py, px, g))))
    _, Z, Y, X = a.shape
    fr = _fracs(pz, py, px)
    W = [[_w1d(float(o) - f) for o in range(3)] for f in fr]
    D = [[-_dw1d(float(o) - f) for o in range(3)] for f in fr]  # du/dp=-1
    da = torch.zeros_like(a)
    az, ay, ax = (torch.zeros_like(a) for _ in range(3))
    for oz, oy, ox in _OFFSETS:
        gs = torch.zeros((Z, Y, X), dtype=torch.float32, device=a.device)
        gs[:Z - oz, :Y - oy, :X - ox] = g[oz:, oy:, ox:]
        da = da + W[0][oz] * W[1][oy] * W[2][ox] * gs
        az = az + D[0][oz] * W[1][oy] * W[2][ox] * gs
        ay = ay + W[0][oz] * D[1][oy] * W[2][ox] * gs
        ax = ax + W[0][oz] * W[1][oy] * D[2][ox] * gs
    return da, az * a, ay * a, ax * a


def _color_bins(p, dens, color, valid, K, pshape):
    """One keyframe's dense slots as K4c/K5c read them: the valid mask
    (K, Zp, Yp, Xp), the five channels [density, colour clipped to [0,
    1], ones] (5, K, Zp, Yp, Xp) and the three fracs (K, Zp, Yp, Xp),
    all 0 where a slot is not valid (such a slot may hold anything)."""
    bins = (K,) + tuple(pshape)
    n = math.prod(bins)
    v = valid.view(bins)
    a = torch.stack([dens[:n], *color[:, :n].clamp(0.0, 1.0),
                     torch.ones_like(dens[:n])]).view((5,) + bins)
    fr = _fracs(*(p[d, :n].view(bins) for d in range(3)))
    return v, torch.where(v, a, 0.0), [torch.where(v, f, 0.0) for f in fr]


def window_color_fwd_plain(p, dens, color, valid, K, shape) -> torch.Tensor:
    """K4c on tensors: the (Z, Y, X, 5) splat of [density, colour clipped
    to [0, 1], ones] on the unpadded grid ``shape``, as 27 shifted adds of
    the five channels over the bins, the padded splat cropped; a keyframe
    batch keyframe by keyframe."""
    if p.ndim == 3:
        return torch.stack([window_color_fwd_plain(*t, K, shape)
                            for t in zip(p, dens, color, valid)])
    pshape = padded_shape(shape)
    _, a, fr = _color_bins(p, dens, color, valid, K, pshape)
    W = [[_w1d(float(o) - f) for o in range(3)] for f in fr]
    Zp, Yp, Xp = pshape
    out = torch.zeros((5,) + pshape, dtype=torch.float32, device=p.device)
    for oz, oy, ox in _OFFSETS:
        contrib = (W[0][oz] * W[1][oy] * W[2][ox] * a).sum(dim=1)
        out[:, oz:, oy:, ox:] += contrib[:, :Zp - oz, :Yp - oy, :Xp - ox]
    Z, Y, X = shape
    return out[:, PAD:PAD + Z, PAD:PAD + Y, PAD:PAD + X].permute(
        1, 2, 3, 0).contiguous()


def window_color_bwd_plain(p, dens, color, valid, g, K
                           ) -> Tuple[torch.Tensor, ...]:
    """K5c on tensors: (dp, ddens, dcolor), shaped as p (3, S), dens (S,)
    and color (3, S), given the cotangent g (Z, Y, X, 5) of the colour
    splat, read at g[b + off] (zero on the PAD ring and beyond); 0 in the
    slots that are not valid and in the parked ones; the colour's through
    the clip's subgradient (0.5 at a bound). A keyframe batch keyframe by
    keyframe."""
    if p.ndim == 3:
        return tuple(torch.stack(r) for r in zip(*(
            window_color_bwd_plain(*t, K)
            for t in zip(p, dens, color, valid, g))))
    pshape = padded_shape(g.shape[:3])
    v, a, fr = _color_bins(p, dens, color, valid, K, pshape)
    W = [[_w1d(float(o) - f) for o in range(3)] for f in fr]
    D = [[-_dw1d(float(o) - f) for o in range(3)] for f in fr]  # du/dp=-1
    Zp, Yp, Xp = pshape
    gp = F.pad(g.permute(3, 0, 1, 2), (PAD, PAD) * 3)   # zero ring
    s = torch.zeros_like(a[:4])
    az, ay, ax = (torch.zeros_like(a[0]) for _ in range(3))
    for oz, oy, ox in _OFFSETS:
        gs = torch.zeros((5,) + pshape, dtype=torch.float32, device=g.device)
        gs[:, :Zp - oz, :Yp - oy, :Xp - ox] = gp[:, oz:, oy:, ox:]
        s = s + W[0][oz] * W[1][oy] * W[2][ox] * gs[:4, None]
        # the cotangent of this tap's weight: attributes times cotangents
        h = (a * gs[:, None]).sum(dim=0)
        az = az + D[0][oz] * W[1][oy] * W[2][ox] * h
        ay = ay + W[0][oz] * D[1][oy] * W[2][ox] * h
        ax = ax + W[0][oz] * W[1][oy] * D[2][ox] * h
    S = p.shape[-1]

    def slots(x):
        """(C, K, Zp, Yp, Xp) dense-slot values -> (C, S), 0 where not
        valid and in the parking slots."""
        x = torch.where(v, x, 0.0).reshape(x.shape[0], -1)
        return F.pad(x, (0, S - x.shape[1]))

    dcolor = slots(s[1:]) * _clip_grad(color, 0.0, 1.0)
    return slots(torch.stack([az, ay, ax])), slots(s[:1])[0], dcolor


# --------------------------------------------------------------------- #
# wrappers: plain version on CPU tensors, CUDA kernel on CUDA tensors
# --------------------------------------------------------------------- #

def _check_bins(a, pz, py, px, *g):
    """The bin arrays' checks, and g's when given (_cuda_build.check):
    (K, Zp, Yp, Xp) bins and a (Zp, Yp, Xp) g, or a keyframe batch of
    (B, K, Zp, Yp, Xp) bins and a (B, Zp, Yp, Xp) g."""
    if a.ndim not in (4, 5):
        raise ValueError(f"a: expected ([B,] K, Zp, Yp, Xp), got "
                         f"{tuple(a.shape)}")
    s = a.shape
    cells = s[:1] + s[2:] if a.ndim == 5 else s[1:]
    _cuda_build.check("binned-splat kernels", ("a", "p_z", "p_y", "p_x", "g"),
                      (a, pz, py, px, *g), (s, s, s, s, cells))


def binsplat_fwd(a, pz, py, px) -> torch.Tensor:
    """K4: the padded (Zp, Yp, Xp) splat of the bins ((B, Zp, Yp, Xp)
    of a keyframe batch, in one launch)."""
    if a.is_cuda:
        out = load_library().binsplat_fwd.default(a, pz, py, px)
        LAUNCHES["fwd"] += 1
        return out
    _check_bins(a, pz, py, px)
    return window_fwd_plain(a, pz, py, px)


def binsplat_bwd(a, pz, py, px, g) -> Tuple[torch.Tensor, ...]:
    """K5: (da, dp_z, dp_y, dp_x) given the padded splat's cotangent g
    (of a keyframe batch too, in one launch)."""
    if a.is_cuda:
        grads = load_library().binsplat_bwd.default(a, pz, py, px, g)
        LAUNCHES["bwd"] += 1
        return grads
    _check_bins(a, pz, py, px, g)
    return window_bwd_plain(a, pz, py, px, g)


def _check_color_bins(p, dens, color, valid, K, shape, *g):
    """The colour bins' checks and g's when given (_cuda_build.check):
    p (3, S), dens (S,), color (3, S) float32 and valid (n_slots,) bool,
    n_slots = K * prod(padded shape) <= S, and a (Z, Y, X, 5) g; or all
    with a leading keyframe B."""
    if p.ndim not in (2, 3):
        raise ValueError(f"p: expected ([B,] 3, S), got {tuple(p.shape)}")
    lead, S = tuple(p.shape[:-2]), p.shape[-1]
    n_slots = K * math.prod(padded_shape(shape))
    f32 = _cuda_build.F32
    _cuda_build.check(
        "colour window kernels", ("p", "dens", "color", "valid", "g"),
        (p, dens, color, valid, *g),
        (lead + (3, S), lead + (S,), lead + (3, S), lead + (n_slots,),
         lead + tuple(shape) + (5,)),
        (f32, f32, f32, torch.bool, f32))
    if n_slots > S:
        raise ValueError(f"valid: {n_slots} dense slots, more than p's {S}")


def binsplat_color_fwd(p, dens, color, valid, K: int, shape
                       ) -> torch.Tensor:
    """K4c: the (Z, Y, X, 5) colour splat [density, colour clipped to [0,
    1], ones] of the bins on the unpadded grid ``shape`` ((B, Z, Y, X, 5)
    of a keyframe batch, in one launch)."""
    if p.is_cuda:
        out = load_library().binsplat_color_fwd.default(
            p, dens, color, valid, K, *shape)
        LAUNCHES["color_fwd"] += 1
        return out
    _check_color_bins(p, dens, color, valid, K, shape)
    return window_color_fwd_plain(p, dens, color, valid, K, shape)


def binsplat_color_bwd(p, dens, color, valid, g, K: int
                       ) -> Tuple[torch.Tensor, ...]:
    """K5c: (dp, ddens, dcolor) given the colour splat's cotangent g (of a
    keyframe batch too, in one launch)."""
    if p.is_cuda:
        grads = load_library().binsplat_color_bwd.default(
            p, dens, color, valid, g, K)
        LAUNCHES["color_bwd"] += 1
        return grads
    _check_color_bins(p, dens, color, valid, K, tuple(g.shape[-4:-1]), g)
    return window_color_bwd_plain(p, dens, color, valid, g, K)


class BinWindow(torch.autograd.Function):
    """Differentiable binned window splat of four (K, Zp, Yp, Xp) bin
    arrays to the padded (Zp, Yp, Xp) grid (or of a keyframe batch's
    (B, K, Zp, Yp, Xp) to (B, Zp, Yp, Xp)): ``BinWindow.apply(a, p_z,
    p_y, p_x)``. Counterpart of ``_window_pallas``' custom VJP: K4 forward,
    K5 backward (all four gradients in one launch, as on the TPU). Empty
    slots must carry a == 0, so their value and position gradient are
    exactly 0."""

    @staticmethod
    def forward(ctx, a, pz, py, px):
        a, pz, py, px = (t.contiguous() for t in (a, pz, py, px))
        ctx.save_for_backward(a, pz, py, px)
        return binsplat_fwd(a, pz, py, px)

    @staticmethod
    def backward(ctx, g):
        return binsplat_bwd(*ctx.saved_tensors, g.contiguous())


def splat_binned_window(p_b: torch.Tensor, attr_b: torch.Tensor,
                        valid: torch.Tensor, shape, K: int) -> torch.Tensor:
    """Drop-in for ``ops.binsplat.splat_binned`` (3D, single-channel
    attribute, bspline) through :class:`BinWindow`: masks the attribute by
    ``valid``, runs the window on the dense slots viewed as (K, Zp, Yp, Xp)
    and crops the PAD ring. A keyframe batch's (B, 3, S) positions, (B, S)
    attributes and (B, n_slots) ``valid`` give (B, Z, Y, X) in one launch
    of each kernel. Differentiable in ``p_b`` and ``attr_b``; parked and
    empty slots get exactly zero gradient."""
    with span("nfs.splat"):
        lead = valid.ndim - 1
        if len(shape) != 3 or attr_b.ndim != 1 + lead:
            raise ValueError("splat_binned_window takes 3D grids and a "
                             "single-channel attribute; use splat_binned for "
                             "2D grids or channels")
        pshape = padded_shape(shape)
        n_slots = math.prod(pshape) * K
        bins = attr_b.shape[:lead] + (K,) + pshape
        a4 = torch.where(valid, attr_b[..., :n_slots], 0.0).view(bins)
        p4 = [p_b[..., d, :n_slots].reshape(bins) for d in range(3)]
        out = BinWindow.apply(a4, *p4)
        Z, Y, X = shape
        return out[..., PAD:PAD + Z, PAD:PAD + Y, PAD:PAD + X]


class BinColorWindow(torch.autograd.Function):
    """Differentiable colour splat of slot-minor bins to the unpadded
    (Z, Y, X, 5) grid [density, colour clipped to [0, 1], ones]:
    ``BinColorWindow.apply(p, dens, color, valid, K, shape)``, a keyframe
    batch with a leading B on all. K4c forward, K5c backward (the
    position, density and colour gradients in one launch). It keeps the
    bins alone for the backward, no per-tap weights. ``valid`` takes no
    gradient; slots that are not valid and parked ones get exactly 0."""

    @staticmethod
    def forward(ctx, p, dens, color, valid, K, shape):
        p, dens, color, valid = (t.contiguous()
                                 for t in (p, dens, color, valid))
        ctx.save_for_backward(p, dens, color, valid)
        ctx.K = K
        return binsplat_color_fwd(p, dens, color, valid, K, shape)

    @staticmethod
    def backward(ctx, g):
        return (*binsplat_color_bwd(*ctx.saved_tensors, g.contiguous(),
                                    ctx.K), None, None, None)


def splat_binned_color_window(p_b: torch.Tensor, dens_b: torch.Tensor,
                              color_b: torch.Tensor, valid: torch.Tensor,
                              shape, K: int):
    """LNST's colour pass through K4c/K5c: the route of
    ``ops.binsplat.splat_binned_color`` for 3D grids and the B-spline
    kernel, with the same arguments and results (the density grid and the
    colour grid normalized by the ones channel plus 1e-6)."""
    with span("nfs.splat_color"):
        if len(shape) != 3:
            raise ValueError("splat_binned_color_window takes 3D grids; use "
                             "splat_binned_color for 2D grids")
        out = BinColorWindow.apply(p_b, dens_b, color_b, valid, K,
                                   tuple(shape))
        return out[..., 0], out[..., 1:4] / (out[..., 4:5] + 1e-6)
