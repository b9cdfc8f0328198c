"""Binned dense particle-to-grid splatting (counterpart of
``nfs_tpu/ops/binsplat.py``; LNST §4.1).

  1. ``bin_particles``: once per chunk of iterations, sort particles into
     dense (K, cells) bins keyed by the kernel's base cell (a stable sort
     plus one N-sized scatter).
  2. ``splat_binned``: every iteration, the splat is 27 (3D) / 9 (2D)
     dense shifted adds over the bin arrays, and its gradient is as dense.
     The 3D single-channel B-spline case goes through the CUDA window
     kernels instead (``ops/binsplat_kernels.py``); LNST's colour takes
     ``splat_binned_color``, one 5-channel pass, whose 3D B-spline case
     the styler sends to the window kernels' colour pair K4c/K5c
     (``binsplat_kernels.splat_binned_color_window``).

Layouts, as in the JAX package: binned payloads are SLOT-MINOR, vectors
``(C, n_slots + N)``; slots are rank-major (``slot = rank * n_cells +
cell``), so the dense region ``[:n_slots]`` views as ``(K, *padded_shape)``
without a copy. The domain is padded by ``PAD`` cells per side, so
boundary particles keep their in-bounds taps while taps beyond the grid
are cropped (the flat splat's dropped taps).

Ranks within a cell follow a STABLE sort of the base cells, as
``jnp.argsort`` (stable by default) gives them, so the same particles park
on overflow in both packages (ROADMAP queue 3, F7).

Positions may drift from their binned cell between rebins; taps stay
anchored at the binned base cell, so weight that drifts past the 3-tap
support is truncated, an O(drift^2) error the rebin cadence bounds.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from nfs_tpu_torch.ops.jaxgrad import jax_clip
from nfs_tpu_torch.ops.splat import _kernel_weight_1d
from nfs_tpu_torch.utils.profiling import span

PAD = 2  # bin-domain padding (cells per side) for boundary-tap fidelity


class Binning(NamedTuple):
    """Maps N particles to a slot space of n_slots + N, where n_slots =
    prod(padded cells) * K.

    Slots [0, n_slots) are the dense rank-major (K, cells) bin region.
    Slots [n_slots, n_slots + N) are per-particle PARKING slots: a
    particle whose bin already holds K others lands there, keeps an exact
    attribute round trip, and is left out of the splat until the next
    rebin.

    slot[i] = slot of canonical particle i; valid marks dense slots that
    hold a particle; n_overflow counts parked particles.
    """

    slot: torch.Tensor        # (N,) int64 in [0, n_slots + N)
    valid: torch.Tensor       # (n_slots,) bool
    n_overflow: torch.Tensor  # () int64


def padded_shape(shape: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(s) + 2 * PAD for s in shape)


def n_taps(kernel: str) -> int:
    """Per-axis window width: the quadratic B-spline covers 3 cells, the
    linear tent 2."""
    if kernel == "bspline":
        return 3
    if kernel == "linear":
        return 2
    raise ValueError(f"binned splat supports 'bspline'|'linear', "
                     f"got {kernel!r}")


def _base_cells(p: torch.Tensor, shape: Sequence[int],
                kernel: str = "bspline") -> torch.Tensor:
    """Kernel base cell in PADDED coordinates (bspline floor(p - 0.5),
    linear floor(p)), clamped to [0, padded - n_taps] so every particle
    owns a padded bin and a base's taps never leave the padded grid."""
    t = n_taps(kernel)
    base = torch.floor(p - 0.5 * (t - 2)).long() + PAD
    hi = torch.tensor([int(s) + 2 * PAD - t for s in shape],
                      dtype=torch.long, device=p.device)
    return torch.clamp(base, min=0).minimum(hi)


def _flat_base(p: torch.Tensor, shape: Sequence[int],
               kernel: str = "bspline") -> torch.Tensor:
    base = _base_cells(p, shape, kernel)
    pshape = padded_shape(shape)
    flat = base[:, 0]
    for d in range(1, len(pshape)):
        flat = flat * pshape[d] + base[:, d]
    return flat


def _bin_counts(p: torch.Tensor, shape, kernel: str) -> torch.Tensor:
    """Particles per padded cell: (n_cells,) for (N, dim) positions, or
    (B, n_cells) for a (B, N, dim) keyframe stack in one bincount."""
    n_cells = math.prod(padded_shape(shape))
    flat = _flat_base(p.detach().reshape(-1, p.shape[-1]), shape, kernel)
    if p.ndim == 2:
        return torch.bincount(flat, minlength=n_cells)
    B = p.shape[0]
    flat = flat + n_cells * torch.arange(
        B, device=p.device).repeat_interleave(p.shape[1])
    return torch.bincount(flat, minlength=B * n_cells).view(B, n_cells)


def max_bin_count(p: torch.Tensor, shape: Sequence[int],
                  kernel: str = "bspline") -> torch.Tensor:
    """Device scalar: most particles sharing one base cell."""
    return _bin_counts(p, shape, kernel).max()


def bin_count_stats(p: torch.Tensor, shape: Sequence[int],
                    kernel: str = "bspline",
                    kcand: int = 16) -> torch.Tensor:
    """(1 + kcand,) int64: [max bin count, parked(1), ..., parked(kcand)],
    where parked(k) = sum over cells of max(count - k, 0), the particles a
    capacity-k binning would park (feeds ParticleConfig.k_budget). A
    (B, N, dim) keyframe stack gives one row per keyframe, (B, 1 +
    kcand)."""
    counts = _bin_counts(p, shape, kernel)
    parked = torch.stack([torch.clamp(counts - k, min=0).sum(dim=-1)
                          for k in range(1, kcand + 1)], dim=-1)
    return torch.cat([counts.max(dim=-1).values[..., None], parked], dim=-1)


def bucket_k(k: int, cap: int = 4096) -> int:
    """Round K up to the next even number (1 and 2 stay as they are)."""
    k = max(int(k), 1)
    if k <= 2:
        return k
    return min(k + (k % 2), cap)


def bin_particles(p: torch.Tensor, shape: Tuple[int, ...], K: int,
                  kernel: str = "bspline",
                  capacity: Optional[torch.Tensor] = None) -> Binning:
    """Assign each particle slot = rank * n_cells + base cell; ranks >= K
    park it. Not differentiable (integer valued). The kernel decides the
    base-cell rule, so binning and the splat must use the same one.

    A (B, N, dim) keyframe stack is binned in one pass: the sort key
    ``b * n_cells + cell`` keeps the keyframes apart and each one's
    stable ranks (F7), so the Binning's slot (B, N), valid (B, n_slots)
    and n_overflow (B,) rows are the B single binnings' bit for bit.
    ``capacity`` (B,) gives each keyframe its own capacity (at most K):
    keyframe b parks the particles of rank >= capacity[b], as a single
    binning with K = capacity[b] parks them, in the layout of K ranks."""
    with span("nfs.splat"):
        p = p.detach()
        batched = p.ndim == 3
        pb = p if batched else p[None]
        B, n = pb.shape[0], pb.shape[1]
        n_cells = math.prod(padded_shape(shape))
        n_slots = n_cells * K
        dev = p.device
        flat = _flat_base(pb.reshape(B * n, pb.shape[-1]), shape, kernel)
        kf = torch.arange(B, device=dev).repeat_interleave(n)
        key_s, order = torch.sort(flat + kf * n_cells, stable=True)
        flat_s = key_s - kf * n_cells        # sorted by keyframe, then cell
        ar = torch.arange(B * n, device=dev)
        new_seg = torch.ones(B * n, dtype=torch.bool, device=dev)
        new_seg[1:] = key_s[1:] != key_s[:-1]
        seg_start = torch.cummax(torch.where(new_seg, ar, 0), dim=0).values
        rank = ar - seg_start
        ok = rank < (K if capacity is None
                     else capacity.to(device=dev, dtype=torch.long)[kf])
        slot_sorted = torch.where(ok, rank.clamp(max=K - 1) * n_cells + flat_s,
                                  n_slots + order - kf * n)   # park overflow
        slot = torch.empty_like(slot_sorted)
        slot[order] = slot_sorted                       # canonical order
        valid = torch.zeros((B, n_slots + 1), dtype=torch.bool, device=dev)
        valid.view(-1)[kf * (n_slots + 1) + torch.where(ok, slot_sorted,
                                                        n_slots)] = True
        n_over = (~ok).view(B, n).sum(dim=1)
        if batched:
            return Binning(slot=slot.view(B, n), valid=valid[:, :n_slots],
                           n_overflow=n_over)
        return Binning(slot=slot, valid=valid[0, :n_slots],
                       n_overflow=n_over[0])


def to_binned(binning: Binning, arr: torch.Tensor) -> torch.Tensor:
    """Canonical -> binned, slot-minor: (N,) -> (n_slots + N,) and (N, C)
    -> (C, n_slots + N), empty slots zero; with a keyframe batch's
    Binning, (B, N) -> (B, n_slots + N) and (B, N, C) -> (B, C, n_slots
    + N). Differentiable in ``arr``."""
    n_total = binning.valid.shape[-1] + binning.slot.shape[-1]
    if binning.slot.ndim == 2:
        B = arr.shape[0]
        if arr.ndim == 2:
            return arr.new_zeros((B, n_total)).scatter(1, binning.slot, arr)
        a = arr.transpose(1, 2)
        return a.new_zeros((B, a.shape[1], n_total)).scatter(
            2, binning.slot[:, None].expand(a.shape), a)
    zero = arr.new_zeros(n_total)
    if arr.ndim == 1:
        return zero.index_copy(0, binning.slot, arr)
    assert arr.ndim == 2
    return torch.stack([zero.index_copy(0, binning.slot, arr[:, c])
                        for c in range(arr.shape[1])])


def from_binned(binning: Binning, arr: torch.Tensor) -> torch.Tensor:
    """Binned -> canonical: (n_slots + N,) -> (N,), (C, n_slots + N) ->
    (N, C), and per keyframe of a batch's Binning. Exact inverse of
    ``to_binned`` for every particle, parked ones included."""
    if binning.slot.ndim == 2:
        if arr.ndim == 2:
            return arr.gather(1, binning.slot)
        idx = binning.slot[:, None].expand(-1, arr.shape[1], -1)
        return arr.gather(2, idx).transpose(1, 2)
    if arr.ndim == 1:
        return arr[binning.slot]
    return arr[:, binning.slot].T


def _shift_into(contrib: torch.Tensor, off, pshape) -> torch.Tensor:
    """contrib[..., b] moved to cell b + off (front zero pad, end crop)
    over the trailing len(pshape) axes."""
    pads = []
    for o in reversed(off):
        pads += [o, 0]
    lead = contrib.ndim - len(pshape)
    crop = (slice(None),) * lead + tuple(slice(0, s) for s in pshape)
    return F.pad(contrib, pads)[crop]


def splat_binned(p_b: torch.Tensor, attr_b: torch.Tensor,
                 valid: torch.Tensor, shape: Tuple[int, ...], K: int,
                 kernel: str = "bspline") -> torch.Tensor:
    """Dense-window splat of binned particles (the generic any-C, 2D/3D,
    bspline/linear formulation; plain torch, differentiable by autograd).

    Args:
      p_b: (dim, n_slots [+ N]) binned positions in UNPADDED grid
        coordinates, binned with the same kernel; the parking region is
        ignored.
      attr_b: (n_slots [+ N],) or (C, n_slots [+ N]) binned attributes.
      valid: (n_slots,) bool from the Binning.
      shape: unpadded output grid shape.

    A keyframe batch's binned arrays (a leading B on all three, ``valid``
    (B, n_slots)) splat in one pass to (B, *shape[, C]), each keyframe
    summed as a single call sums it.

    Returns: (*shape,) or (*shape, C) grid == the flat splat with the same
    kernel at support 1.
    """
    with span("nfs.splat"):
        return _splat_binned(p_b, attr_b, valid, shape, K, kernel)


def splat_binned_color(p_b: torch.Tensor, dens_b: torch.Tensor,
                       color_b: torch.Tensor, valid: torch.Tensor,
                       shape: Tuple[int, ...], K: int,
                       kernel: str = "bspline"):
    """LNST's colour pass over binned particles, as the JAX package runs
    it: one 5-channel :func:`splat_binned` of [density, colour clipped to
    [0, 1] (gradient 0.5 at a bound, as ``jnp.clip``'s), ones], the
    colour grid normalized by the last channel (plus 1e-6).

    ``dens_b`` (n_slots [+ N],), ``color_b`` (3, n_slots [+ N]), or both
    with a leading keyframe B as :func:`splat_binned` takes them. Returns
    the density grid (*shape) and the colour grid (*shape, 3), each with
    the leading B of a batch."""
    with span("nfs.splat_color"):
        attr = torch.cat([dens_b.unsqueeze(-2), jax_clip(color_b, 0.0, 1.0),
                          torch.ones_like(dens_b).unsqueeze(-2)], dim=-2)
        out = _splat_binned(p_b, attr, valid, shape, K, kernel)
        return out[..., 0], out[..., 1:4] / (out[..., 4:5] + 1e-6)


def _splat_binned(p_b, attr_b, valid, shape, K, kernel):
    T = n_taps(kernel)
    ndim = len(shape)
    pshape = padded_shape(shape)
    batched = valid.ndim == 2
    if not batched:
        p_b, attr_b, valid = p_b[None], attr_b[None], valid[None]
    B = p_b.shape[0]
    has_c = attr_b.ndim == 3
    if not has_c:
        attr_b = attr_b[:, None]
    C = attr_b.shape[1]
    n_slots = math.prod(pshape) * K

    a = torch.where(valid[:, None], attr_b[..., :n_slots], 0.0).reshape(
        (B, C, K) + pshape)
    # offset of each particle from its binned base cell, whose coordinate
    # is the slot's own index in the dense array
    frac = []
    for d in range(ndim):
        coord = torch.arange(pshape[d], dtype=torch.float32,
                             device=p_b.device).reshape(
            (pshape[d],) + (1,) * (ndim - 1 - d))
        frac.append(p_b[:, d, :n_slots].reshape((B, K) + pshape)
                    + float(PAD) - coord)
    # factorized per-axis weights, shared by all T^ndim taps
    W = [[_kernel_weight_1d(float(o) - frac[d], kernel) for o in range(T)]
         for d in range(ndim)]
    out = torch.zeros((B, C) + pshape, dtype=a.dtype, device=a.device)
    for off in itertools.product(range(T), repeat=ndim):
        w = W[0][off[0]]
        for d in range(1, ndim):
            w = w * W[d][off[d]]
        contrib = (w[:, None] * a).sum(dim=2)       # contract over K
        out = out + _shift_into(contrib, off, pshape)
    out = out[(slice(None), slice(None)) + tuple(
        slice(PAD, PAD + shape[d]) for d in range(ndim))]
    out = torch.movedim(out, 1, -1) if has_c else out[:, 0]
    return out if batched else out[0]
