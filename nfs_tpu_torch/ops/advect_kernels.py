"""Bounded-displacement advection kernels K1-K3b and their plain twins.

Counterpart of ``nfs_tpu/ops/pallas_advect.py``. The CUDA kernels of
``nfs_tpu_torch/csrc/advect.cu`` replace its four Pallas kernels (K2 has
two routes, by radius):

================  ==========================================  ===================
launch            CUDA kernel (advect.cu)                     replaces
================  ==========================================  ===================
fwd               ``advect_fwd_kernel``        (K1)           ``_fwd_kernel``
bwd_field         ``advect_bwd_field_kernel``  (K2)           ``_bwd_field_kernel``
bwd_field_binned  ``advect_bin_sources_kernel``, a stable     ``_bwd_field_kernel``
                  sort, ``advect_bwd_field_binned_kernel``
                  (K2)
bwd_vel           ``advect_bwd_vel_kernel``    (K3)           ``_bwd_vel_kernel``
bwd_fused         ``advect_bwd_fused_kernel``  (K3b)          ``_bwd_fused_kernel``
================  ==========================================  ===================

``advect_bwd_field_untiled_kernel`` (K2's untiled pull, operator
``advect_bwd_field_untiled``) is on no path: ``chip_smoke.py`` holds the
binned route against it bitwise.

Each wrapper (:func:`advect_fwd`, :func:`advect_bwd_field`,
:func:`advect_bwd_vel`, :func:`advect_bwd_fused`) takes f32 contiguous
tensors: a ``(D, H, W)`` field or cotangent and a ``(D, H, W, 3)``
displacement (velocity already multiplied by ``dt``) in array-axis
channel order, or a batch of B frames of them, ``(B, D, H, W)`` and
``(B, D, H, W, 3)``, frame b advected by displacement b. On a CPU tensor
it runs its plain PyTorch twin (``*_plain``, once per frame of a batch);
on a CUDA tensor it launches the kernel once, whatever B is, and counts
the launch in :data:`LAUNCHES`, or raises. A batched launch gives the
bits of B single ones (``advect.cu``). There is no fallback from CUDA to
the plain twin.

:class:`AdvectWindow`'s backward runs K2 for the field's gradient and K3
for the displacement's, each only when it is asked for. With the module
flag :data:`FUSED_BWD` set, a backward that needs both runs K3b once for
the two, as the JAX package's ``FUSED_BWD`` does. The flag is read at
backward time.

The TPU kernels evaluate every tap of the (2K+1)^3 window from VMEM
because a gather is slow on the TPU. On Hopper a gather through L1 is
cheap, so the kernels visit only the taps whose weight can be nonzero
(8 for K1, 20 of 27 for K3, (2R+1)^3 source cells for K2 and K3b with
R = ceil(max_disp)); the result equals the window sum. K1 and K3 give
each thread one (y, x) and a run of cells along z; they stage nothing,
so any shape and max_disp launches. K2 and K3b give each block a tile
of output cells and stage its sources, with an R-cell halo, in shared
memory; :func:`_pull_plan` picks the tile and its bytes from R. Past
R = 7 no K3b tile fits, and K3b's wrapper runs K2 and K3. From
R = :data:`BINNED_FROM_R` (before its tiles run out at R = 8) K2 takes
its binned route (:func:`_binned_route`: every source keyed by its floor
cell, the keys sorted stably, each cell's gather merging the runs of its
8 floor cells by source index; the same bits, with work that does not
grow with R). The route is chosen from R alone, before any launch. What
bounds each kernel on the H100 and what the design does about it is
noted in ``advect.cu``.

The library is built with ``nvcc`` for ``sm_90a`` from the repository's
own source at first use into ``build/nfs_tpu_torch/`` next to the
package, under a file name keyed on a hash of the source and flags. On
CUDA tensors each wrapper calls its operator ``torch.ops.nfs_tpu_torch``
(``csrc/ops.cpp``), which checks the tensors and launches on the current
stream in C++ (``ops/_cuda_build.py``, shared with the binned-splat
kernels).
"""

from __future__ import annotations

import functools
import itertools
import math
from pathlib import Path
from typing import Dict

import torch

from nfs_tpu_torch.ops import _cuda_build

# Launch counts of the CUDA kernels; each wrapper adds one where it
# launches, and nowhere else.
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd_field": 0,
                            "bwd_field_binned": 0, "bwd_vel": 0,
                            "bwd_fused": 0}

# Backward of AdvectWindow: K2 and K3, each only when its gradient is
# asked for; with True, K3b once where both are (pallas_advect.py
# FUSED_BWD). Read at backward time, so an A/B flips it between steps.
FUSED_BWD = False

SOURCE = _cuda_build.CSRC / "advect.cu"
BUILD_DIR = _cuda_build.BUILD_DIR


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------- #
# build + load
# --------------------------------------------------------------------- #

def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    return _cuda_build.library_path(SOURCE, "nfs_advect")


def build_library() -> Path:
    """Compile advect.cu unless a library for this source already exists
    (``ops/_cuda_build.py``)."""
    return _cuda_build.build_library(SOURCE, "nfs_advect")


# Build (first use) and load the kernels and the operators that launch
# them; returns ``torch.ops.nfs_tpu_torch`` (ops/_cuda_build.py).
load_library = _cuda_build.load_operators


# --------------------------------------------------------------------- #
# shared math (plain twins and the gradient chain)
# --------------------------------------------------------------------- #

def _tent(u: torch.Tensor) -> torch.Tensor:
    """max(0, 1 - |u|) (pallas_advect.py _tent)."""
    return torch.clamp(1.0 - u.abs(), min=0.0)


def _dtent(u: torch.Tensor) -> torch.Tensor:
    """d/du tent with JAX's subgradients: abs'(0) = +1, 0.5 at |u| == 1
    (pallas_advect.py _dtent)."""
    sgn = torch.where(u >= 0.0, 1.0, -1.0)
    au = u.abs()
    mag = torch.where(au < 1.0, 1.0, torch.where(au == 1.0, 0.5, 0.0))
    return -sgn * mag


def _axes(shape, device):
    """Per-axis float index tensors broadcastable against (D, H, W)."""
    D, H, W = shape
    f32 = torch.float32
    return (torch.arange(D, dtype=f32, device=device).view(D, 1, 1),
            torch.arange(H, dtype=f32, device=device).view(1, H, 1),
            torch.arange(W, dtype=f32, device=device).view(1, 1, W))


def backtrace(vel: torch.Tensor, max_disp: float):
    """Clamped backtrace coordinates (s_z, s_y, s_x), each (D, H, W)
    (with vel's leading batch axis, if any)."""
    shape = vel.shape[-4:-1]
    disp = vel.clamp(-max_disp, max_disp)
    idx = _axes(shape, vel.device)
    return [(idx[a] - disp[..., a]).clamp(0.0, shape[a] - 1)
            for a in range(3)]


def _clip_grad(x, lo, hi):
    """JAX's clip subgradient: 1 strictly inside, 0 outside, 0.5 at a
    bound (pallas_advect.py:495)."""
    inside = ((x > lo) & (x < hi)).to(torch.float32)
    at_edge = ((x == lo) | (x == hi)).to(torch.float32)
    return inside + 0.5 * at_edge


@functools.lru_cache(maxsize=None)
def _last_cells(D: int, H: int, W: int, device: torch.device) -> torch.Tensor:
    """(D - 1, H - 1, W - 1) in float32, built once per shape and device:
    building it on a GPU copies from the host, which waits for the device
    and cannot be captured in a CUDA graph."""
    return torch.tensor([D - 1, H - 1, W - 1], dtype=torch.float32,
                        device=device)


def vel_grad_chain(grad_s: torch.Tensor, vel: torch.Tensor,
                   max_disp: float, kernel_vel=None) -> torch.Tensor:
    """grad wrt the displacement from grad wrt s = clip(i - clip(v)):
    ``-grad_s * outer * inner`` (pallas_advect.py:492-508, dt = 1), for
    one displacement or a batch of them. ``kernel_vel``: the displacement
    the kernels were given in place of ``vel`` (:func:`slab_displacement`),
    whose backtrace the outer clip reads; the inner clip reads ``vel``."""
    D, H, W = vel.shape[-4:-1]
    idx = torch.stack(torch.broadcast_tensors(*_axes((D, H, W), vel.device)),
                      dim=-1)
    sizes = _last_cells(D, H, W, vel.device)
    v = vel.to(torch.float32)
    k = v if kernel_vel is None else kernel_vel
    outer = _clip_grad(idx - k.clamp(-max_disp, max_disp), 0.0, sizes)
    inner = _clip_grad(v, -max_disp, max_disp)
    return -grad_s * outer * inner


def slab_displacement(vel: torch.Tensor, max_disp: float, axis: int,
                      offset: int) -> torch.Tensor:
    """The displacement K1-K3b take on a slab of a volume whose cell i
    along spatial ``axis`` is cell ``i + offset`` of the whole volume: the
    component along ``axis`` becomes ``g - (g - clip(v))`` in float32, g
    the cell's index in the whole volume. That is exact, so a kernel's
    backtrace ``i - d`` on the slab is the whole volume's ``g - clip(v)``,
    rounded at g, less ``offset``: every weight and tap is the whole
    volume's, bit for bit, where ``i - clip(v)`` itself would round at i.
    (``max_disp`` must be exact at the volume's indices, as 1, 2 or 1.5
    are.) (D, H, W, 3) or (B, D, H, W, 3); offset 0 returns ``vel``."""
    if offset == 0:
        return vel
    n = vel.shape[-4 + axis]
    view = [1, 1, 1, 1]
    view[axis] = n
    g = (torch.arange(n, dtype=torch.float32, device=vel.device)
         + offset).view(view)
    comp = vel[..., axis:axis + 1].to(torch.float32).clamp(-max_disp,
                                                          max_disp)
    return torch.cat([vel[..., :axis], g - (g - comp),
                      vel[..., axis + 1:]], dim=-1)


def _corner(s, c, n):
    """Tap c (float tensor of integer values) along an axis of size n:
    (clamped long index, tent weight with out-of-grid taps zeroed)."""
    ok = (c >= 0) & (c <= n - 1)
    w = torch.where(ok, _tent(s - c), 0.0)
    return c.clamp(0, n - 1).long(), w, ok


def _per_frame(plain):
    """Let a plain twin of one frame take a batch as well: with a
    (B, D, H, W, 3) displacement among its arguments it runs once per
    frame b on the b-th slice of every tensor argument and stacks the
    results."""
    @functools.wraps(plain)
    def run(*args):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if max(t.ndim for t in tensors) < 5:
            return plain(*args)
        outs = [plain(*(a[b] if isinstance(a, torch.Tensor) else a
                        for a in args))
                for b in range(tensors[0].shape[0])]
        if isinstance(outs[0], tuple):
            return tuple(torch.stack(o) for o in zip(*outs))
        return torch.stack(outs)
    return run


@_per_frame
def advect_fwd_plain(field: torch.Tensor, vel: torch.Tensor,
                     max_disp: float) -> torch.Tensor:
    """K1 on tensors: trilinear sample at s over the 8 corners, corners
    outside the grid reading 0."""
    D, H, W = field.shape
    s = backtrace(vel, max_disp)
    base = [torch.floor(x) for x in s]
    flat = field.reshape(-1)
    out = torch.zeros_like(field)
    for cz in (0, 1):
        iz, wz, _ = _corner(s[0], base[0] + cz, D)
        for cy in (0, 1):
            iy, wy, _ = _corner(s[1], base[1] + cy, H)
            for cx in (0, 1):
                ix, wx, _ = _corner(s[2], base[2] + cx, W)
                out = out + wz * wy * wx * flat[(iz * H + iy) * W + ix]
    return out


@_per_frame
def advect_bwd_field_plain(vel: torch.Tensor, g: torch.Tensor,
                           max_disp: float) -> torch.Tensor:
    """K2 on tensors: the adjoint of K1, scattered with ``index_add_``
    over the 8 corners of every source cell."""
    D, H, W = g.shape
    s = backtrace(vel, max_disp)
    base = [torch.floor(x) for x in s]
    out = torch.zeros(D * H * W, dtype=torch.float32, device=g.device)
    for cz in (0, 1):
        iz, wz, _ = _corner(s[0], base[0] + cz, D)
        for cy in (0, 1):
            iy, wy, _ = _corner(s[1], base[1] + cy, H)
            for cx in (0, 1):
                ix, wx, _ = _corner(s[2], base[2] + cx, W)
                lin = ((iz * H + iy) * W + ix).reshape(-1)
                out.index_add_(0, lin, (wz * wy * wx * g).reshape(-1))
    return out.view(D, H, W)


def bin_sources_plain(vel: torch.Tensor, g: torch.Tensor,
                      max_disp: float):
    """Step 1 of K2's binned route on tensors (``advect_bin_sources_kernel``):
    (keys, records) of every source cell of a (D, H, W) cotangent or a
    (B, D, H, W) batch. A key (int32, shaped as g) is the index over the
    batch, b * D * H * W + (z * H + y) * W + x, of the source's floor
    cell floor(s); a record (float32, g's shape + (4,)) is (s_z, s_y, s_x,
    g), the source's backtrace and cotangent."""
    D, H, W = g.shape[-3:]
    s = backtrace(vel, max_disp)
    c = [torch.floor(x).to(torch.int32) for x in s]
    keys = (c[0] * H + c[1]) * W + c[2]
    if g.ndim == 4:
        keys = keys + D * H * W * torch.arange(
            g.shape[0], dtype=torch.int32, device=g.device).view(-1, 1, 1, 1)
    return keys, torch.stack([*s, g], dim=-1)


def order_sources(keys: torch.Tensor):
    """Step 2 of K2's binned route, the same code on either device: the
    source indices sorted stably by key (``perm``, int64), so that the
    sources of one floor cell form a run in ascending source index, and
    the runs' ``offsets`` (int32, one more than the cells): the run of
    floor cell c is ``perm[offsets[c]:offsets[c + 1]]``."""
    flat = keys.reshape(-1)
    sorted_keys, perm = torch.sort(flat, stable=True)
    cells = torch.arange(flat.numel() + 1, dtype=torch.int32,
                         device=keys.device)
    return perm, torch.searchsorted(sorted_keys, cells, out_int32=True)


def gather_binned_plain(rec: torch.Tensor, perm: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """Step 3 of K2's binned route on tensors
    (``advect_bwd_field_binned_kernel``): each output cell j merges the
    runs of its floor cells j - d, d in {0, 1}^3, by source index and
    adds ((w_z * w_y) * w_x) * g source by source in that order. The
    gradient, shaped as ``rec`` less its last axis."""
    shape = rec.shape[:-1]
    D, H, W = shape[-3:]
    n = rec[..., 0].numel()
    dev = rec.device
    j = torch.arange(n, device=dev)
    b, cell = j // (D * H * W), j % (D * H * W)
    z, y, x = cell // (H * W), cell // W % H, cell % W
    fz, fy, fx = (a.to(torch.float32) for a in (z, y, x))
    starts, lengths = [], []
    for dz, dy, dx in itertools.product((0, 1), repeat=3):
        ok = (z >= dz) & (y >= dy) & (x >= dx)
        c = torch.where(ok, b * (D * H * W) + ((z - dz) * H + y - dy) * W
                        + x - dx, 0)
        lo, hi = offsets[c].long(), offsets[c + 1].long()
        starts.append(lo)
        lengths.append(torch.where(ok, hi - lo, 0))
    start, length = torch.stack(starts, 1), torch.stack(lengths, 1)
    run = torch.arange(int(length.max()) if n else 0, device=dev)
    live = run < length[..., None]                      # (n, 8, longest)
    src = torch.where(live, perm[(start[..., None] + run).clamp(max=n - 1)],
                      n)
    merged = torch.sort(src.reshape(n, -1), dim=1).values  # n: none left
    q = rec.reshape(n, 4)
    acc = torch.zeros(n, dtype=torch.float32, device=dev)
    for t in range(int(live.sum((1, 2)).max()) if n else 0):
        i = merged[:, t]
        qi = q[i.clamp(max=n - 1)]
        wzy = _tent(qi[:, 0] - fz) * _tent(qi[:, 1] - fy)
        acc = torch.where(i < n, acc + wzy * _tent(qi[:, 2] - fx) * qi[:, 3],
                          acc)
    return acc.view(shape)


def advect_bwd_field_binned_plain(vel: torch.Tensor, g: torch.Tensor,
                                  max_disp: float) -> torch.Tensor:
    """K2 by the binned route's three steps on tensors
    (:func:`bin_sources_plain`, :func:`order_sources`,
    :func:`gather_binned_plain`): the layout and order the CUDA route
    relies on, for the tests. A (B, D, H, W) batch is one pass."""
    keys, rec = bin_sources_plain(vel, g, max_disp)
    return gather_binned_plain(rec, *order_sources(keys))


@_per_frame
def advect_bwd_vel_plain(field: torch.Tensor, vel: torch.Tensor,
                         g: torch.Tensor, max_disp: float) -> torch.Tensor:
    """K3 on tensors: (D, H, W, 3) grad wrt s over the 27 taps
    floor(s)-1 .. floor(s)+1 per axis (the tap at floor(s)+2 always has
    |u| > 1). At an integer s this keeps the three-tap subgradient
    (dtent(0) = -1, dtent(+-1) = -+0.5) that a floor-based 2-corner
    gradient would miss."""
    D, H, W = field.shape
    dims = (D, H, W)
    s = backtrace(vel, max_disp)
    flat = field.reshape(-1)
    taps = []
    for a in range(3):
        base = torch.floor(s[a]) - 1.0
        row = []
        for t in range(3):
            c = base + t
            idx, w, ok = _corner(s[a], c, dims[a])
            d = torch.where(ok, _dtent(s[a] - c), 0.0)
            row.append((idx, w, d))
        taps.append(row)
    az = torch.zeros_like(field)
    ay = torch.zeros_like(field)
    ax = torch.zeros_like(field)
    for iz, wz, dz in taps[0]:
        for iy, wy, dy in taps[1]:
            for ix, wx, dx in taps[2]:
                f = flat[(iz * H + iy) * W + ix]
                az = az + dz * wy * wx * f
                ay = ay + wz * dy * wx * f
                ax = ax + wz * wy * dx * f
    return torch.stack([az * g, ay * g, ax * g], dim=-1)


@_per_frame
def advect_bwd_fused_plain(field: torch.Tensor, vel: torch.Tensor,
                           g: torch.Tensor, max_disp: float):
    """K3b on tensors: (K2's gradient wrt the field, K3's wrt s)."""
    return (advect_bwd_field_plain(vel, g, max_disp),
            advect_bwd_vel_plain(field, vel, g, max_disp))


# --------------------------------------------------------------------- #
# wrappers: plain twin on CPU tensors, CUDA kernel on CUDA tensors
# --------------------------------------------------------------------- #

_check = _cuda_build.check


def _shapes(name: str, t: torch.Tensor):
    """(cells, displacement) shapes on the grid of ``t``: a field (D, H,
    W) or a batch (B, D, H, W), as the operators take them."""
    if t.ndim not in (3, 4):
        raise ValueError(f"{name}: expected (D, H, W) or (B, D, H, W), got "
                         f"{tuple(t.shape)}")
    return tuple(t.shape), tuple(t.shape) + (3,)


def _radius(max_disp: float) -> int:
    """K2's source-cell radius: a source i with |i_a - j_a| >
    ceil(max_disp) backtraces to |s_a - j_a| >= 1, where the tent is 0."""
    return int(math.ceil(max_disp))


# Dynamic shared memory one block may use on the H100 (227 KB); the
# output cells each K2 / K3b thread takes along x (advect.cu kCellsX; the
# C entry points refuse a tile whose TX is not a multiple of it); and the
# tile of output cells they start from, (TZ, TY, TX) with x fastest and
# 256 threads (PERF.md names the shapes tried).
SMEM_LIMIT = 232_448
CELLS_X = 3
PULL_TILE = (4, 8, 24)


def _staged_bytes(R: int, tile, fused: bool) -> int:
    """Shared memory K2 (``fused=False``) or K3b stages for a (TZ, TY, TX)
    tile: s_z, s_y, s_x and g of every source of the tile with its R-halo
    (16 B each); K3b adds f over the tile with an (R+1)-halo (4 B
    each)."""
    tz, ty, tx = tile
    src = (tz + 2 * R) * (ty + 2 * R) * (tx + 2 * R)
    f = (tz + 2 * R + 2) * (ty + 2 * R + 2) * (tx + 2 * R + 2) if fused else 0
    return 16 * src + 4 * f


# K2 takes its binned route from this radius up, the tiled pull below it.
# The tiled pull visits (2R+1)^3 sources per cell; the binned route's work
# does not grow with R. On the H100 the binned route is the faster from
# R = 4 (PERF.md §6: chip_smoke.py's kernels phase times both routes at
# R = 2, 3, 4, 5 and 8 and holds them bitwise equal). K2's tile plan ends
# at R = 8, past this.
BINNED_FROM_R = 4


@functools.lru_cache(maxsize=None)
def _pull_plan(R: int, fused: bool = False):
    """(TZ, TY, TX, shared-memory bytes) of K2's or K3b's tile at radius
    R: :data:`PULL_TILE`, with TZ and then TY halved until the staged
    bytes fit in :data:`SMEM_LIMIT`. TX stays 24 (8 threads of
    :data:`CELLS_X` cells). None where even a 1 x 1 x 24 tile does not
    fit: R > 8 for K2, R > 7 for K3b (max_disp above 8 or 7 cells), where
    K3b's wrapper runs K2 and K3. K2's wrapper takes the binned route
    (:func:`_binned_route`, whose gather adds each cell's sources in the
    pull's order and arithmetic, so the tiled pull's bits) from
    :data:`BINNED_FROM_R` up, before its plan runs out. Raises ValueError
    for R < 0."""
    if R < 0:
        raise ValueError(f"advection radius must be >= 0, got {R}")
    tz, ty, tx = PULL_TILE
    while True:
        nbytes = _staged_bytes(R, (tz, ty, tx), fused)
        if nbytes <= SMEM_LIMIT:
            return tz, ty, tx, nbytes
        if tz > 1:
            tz //= 2
        elif ty > 1:
            ty //= 2
        else:
            return None


def advect_fwd(field: torch.Tensor, vel: torch.Tensor,
               max_disp: float) -> torch.Tensor:
    """K1: advected field, (D, H, W) or (B, D, H, W)."""
    if field.is_cuda:
        out = load_library().advect_fwd.default(field, vel, float(max_disp))
        LAUNCHES["fwd"] += 1
        return out
    _check("advection kernels", ("field", "vel"), (field, vel),
           _shapes("field", field))
    return advect_fwd_plain(field, vel, max_disp)


def _binned_route(vel: torch.Tensor, g: torch.Tensor,
                  max_disp: float) -> torch.Tensor:
    """K2's binned route on CUDA tensors, not counted: the key pass
    (operator ``advect_bin_sources``), the stable sort
    (:func:`order_sources`) and the ordered gather (operator
    ``advect_bwd_field_binned``). Its work grows with the cells, not with
    (2R+1)^3; the gather adds each cell's sources in ascending source
    index with the pull's arithmetic, so for finite g it gives the tiled
    and the untiled pull's bits (``advect.cu``)."""
    keys, rec = load_library().advect_bin_sources.default(
        vel, g, float(max_disp))
    return load_library().advect_bwd_field_binned.default(
        rec, *order_sources(keys))


def advect_bwd_field(vel: torch.Tensor, g: torch.Tensor,
                     max_disp: float) -> torch.Tensor:
    """K2: gradient wrt the advected field, shaped as g. On CUDA, the tiled
    pull (:func:`_pull_plan`) below R = ceil(max_disp) =
    :data:`BINNED_FROM_R` and the binned route (:func:`_binned_route`)
    from there, any max_disp >= 0: both add every cell's nonzero terms in
    ascending source index, so the route changes no bit."""
    if g.is_cuda:
        R = _radius(max_disp)
        if R >= BINNED_FROM_R:
            out = _binned_route(vel, g, max_disp)
            LAUNCHES["bwd_field_binned"] += 1
            return out
        out = load_library().advect_bwd_field.default(
            vel, g, float(max_disp), R, *_pull_plan(R))
        LAUNCHES["bwd_field"] += 1
        return out
    _check("advection kernels", ("g", "vel"), (g, vel), _shapes("g", g))
    return advect_bwd_field_plain(vel, g, max_disp)


def advect_bwd_vel(field: torch.Tensor, vel: torch.Tensor,
                   g: torch.Tensor, max_disp: float) -> torch.Tensor:
    """K3: gradient wrt the backtrace coordinates s, shaped as vel."""
    if field.is_cuda:
        out = load_library().advect_bwd_vel.default(field, vel, g,
                                                    float(max_disp))
        LAUNCHES["bwd_vel"] += 1
        return out
    cells, vec = _shapes("field", field)
    _check("advection kernels", ("field", "vel", "g"), (field, vel, g),
           (cells, vec, cells))
    return advect_bwd_vel_plain(field, vel, g, max_disp)


def advect_bwd_fused(field: torch.Tensor, vel: torch.Tensor,
                     g: torch.Tensor, max_disp: float):
    """K3b: (gradient wrt the field, shaped as field, gradient wrt s,
    shaped as vel) in one launch. On CUDA past K3b's tile plan (R =
    ceil(max_disp) > 7) it runs K2 and K3 instead, which give K3b's
    bits, and counts their launches."""
    if field.is_cuda:
        R = _radius(max_disp)
        plan = _pull_plan(R, fused=True)
        if plan is None:
            return (advect_bwd_field(vel, g, max_disp),
                    advect_bwd_vel(field, vel, g, max_disp))
        grads = load_library().advect_bwd_fused.default(
            field, vel, g, float(max_disp), R, *plan)
        LAUNCHES["bwd_fused"] += 1
        return grads
    cells, vec = _shapes("field", field)
    _check("advection kernels", ("field", "vel", "g"), (field, vel, g),
           (cells, vec, cells))
    return advect_bwd_fused_plain(field, vel, g, max_disp)


class AdvectWindow(torch.autograd.Function):
    """Differentiable bounded-displacement advection of a 3D scalar field
    with a clamp boundary: ``AdvectWindow.apply(field, vel_times_dt,
    max_disp)``, or of a batch of frames, (B, D, H, W) fields with (B, D,
    H, W, 3) displacements, each kernel launched once for the batch. Counterpart of ``advect_pallas``' custom VJP. The
    backward runs K2 only when the field needs a gradient and K3 only
    when the displacement does; with :data:`FUSED_BWD` a backward that
    needs both runs K3b once instead (the same values). An optional
    fourth argument ``origin = (axis, offset)`` says the field is a slab
    of a volume, its cell i along ``axis`` the volume's ``i + offset``:
    the kernels then take :func:`slab_displacement`."""

    @staticmethod
    def forward(ctx, field, vel, max_disp, origin=None):
        field = field.contiguous()
        vel = vel.contiguous()
        kvel = (vel if origin is None else
                slab_displacement(vel, max_disp, *origin).contiguous())
        ctx.save_for_backward(field, vel, kvel)
        ctx.slab = origin is not None
        ctx.max_disp = float(max_disp)
        return advect_fwd(field, kvel, ctx.max_disp)

    @staticmethod
    def backward(ctx, g):
        field, vel, kvel = ctx.saved_tensors
        g = g.contiguous()
        need_field, need_vel = ctx.needs_input_grad[:2]
        grad_field = grad_vel = grad_s = None
        if FUSED_BWD and need_field and need_vel:
            grad_field, grad_s = advect_bwd_fused(field, kvel, g,
                                                  ctx.max_disp)
        else:
            if need_field:
                grad_field = advect_bwd_field(kvel, g, ctx.max_disp)
            if need_vel:
                grad_s = advect_bwd_vel(field, kvel, g, ctx.max_disp)
        if grad_s is not None:
            grad_vel = vel_grad_chain(grad_s, vel, ctx.max_disp,
                                      kvel if ctx.slab else None)
        return grad_field, grad_vel, None, None
