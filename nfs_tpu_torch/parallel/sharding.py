"""Sharded stylization on a (frames, views, space) mesh of ranks
(counterpart of ``nfs_tpu/parallel/sharding.py``): frame-parallel
temporal windows with ring halos, view-parallel rendering with gradient
all_reduces, and the collectives of a volume split into slabs over the
``space`` axis.

:func:`make_sharded_window_step` returns the SPMD step every rank of the
mesh runs on its shard: ``n_iters`` Adam iterations on all of its L local
frames at once.

- params, densities and sim velocities are split over ``frames``; each
  rank fetches its +-W neighbour frames' velocities from its ring
  neighbours once per call (:func:`halo_exchange`); a window deeper than
  the local shard all-gathers the velocity stack instead;
- camera views are split over ``views``: each rank renders its slice of
  every frame's view set and computes a partial loss, and the gradients
  (with the loss) are summed EXPLICITLY with ``all_reduce`` over the
  views group before Adam. ``backward`` on a views rank gives only that
  rank's partial gradient: without the reduction each rank would optimize
  with its own views alone and still appear to learn;
- Adam is local to a frame shard (the parameters are frame-local);
- the frames-axis sum of the loss is only reported, so it runs once per
  call over the stacked per-iteration losses.

The JAX package draws each frame's view set on the device from PRNG keys
inside its scanned step; here the caller passes the pool indices
(``view_idx``), which is how the port takes every random draw.

Each call counts the collectives it issues in the step's
``collectives`` attribute (the counterpart of the JAX engine's
``capture_collectives``).

Slabs: where the JAX package leaves a volume sharded over ``space`` to
GSPMD, which inserts the collectives, the port writes them by hand
(``parallel/spatial.py`` uses them): :func:`shard_volume` and
:func:`gather_volume` place and fetch a volume; :class:`SlabHalo` appends
the neighbouring slabs' edge rows to a slab (its backward returns their
gradients to their owners and adds them there), and :class:`SlabGather`
all-gathers the slabs into the volume for a computation every rank of
the space axis repeats identically (its backward is the slice of the
gradient to the rank's own slab). A :class:`SlabRing` says where a slab
sits and how it trades rows with its neighbours: between ranks
(:func:`mesh_ring`), or between slabs run in one process, which is how a
single device checks the slab route.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from nfs_tpu_torch.parallel.mesh import Mesh
from nfs_tpu_torch.styler.octave import Adam, value_and_grad

COLLECTIVES = ("all_reduce", "send", "recv", "all_gather", "broadcast")


def _new_counts() -> Dict[str, int]:
    return dict.fromkeys(COLLECTIVES, 0)


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh,
                  axis: str = "frames", clamp_edges: bool = True,
                  counts: Optional[Dict[str, int]] = None):
    """Fetch ``halo`` boundary elements of the neighbouring shards along a
    sharded leading axis.

    Args:
      x: (L, ...) local chunk of a global (n*L, ...) array split over
        ``axis`` of ``mesh``.
      halo: elements to fetch on each side. halo <= L is one ring
        exchange per side (``batch_isend_irecv``); halo > L (a window
        deeper than the local shard) all-gathers the array along the axis
        and indexes it.
      clamp_edges: out-of-range global positions replicate the global
        first / last element (the sequence styler's clamp at the
        boundary) instead of wrapping around; a message whose contents
        the clamp would replace is not sent.
      counts: optional dict whose "send", "recv" and "all_gather" counts
        are raised by the operations issued.

    Returns:
      (left, right): (halo, ...) tensors, the ``halo`` elements just
      before and just after this shard's global range. An axis of size 1
      does no communication.
    """
    counts = counts if counts is not None else _new_counts()
    x = x.contiguous()
    n = mesh.shape[axis]
    idx = mesh.axis_index(axis)
    L = x.shape[0]
    if halo <= L:
        if n == 1:
            left, right = x[-halo:], x[:halo]
        else:
            ranks = mesh.axis_ranks(axis)
            prev, nxt = ranks[(idx - 1) % n], ranks[(idx + 1) % n]
            first, last = idx == 0, idx == n - 1
            left = torch.empty_like(x[:halo])
            right = torch.empty_like(x[:halo])
            group = mesh.group(axis)
            ops = []
            # my last elements are my right neighbour's left halo, my
            # first its left neighbour's right halo
            if not (clamp_edges and last):
                ops.append(dist.P2POp(dist.isend, x[-halo:], nxt, group))
            if not (clamp_edges and first):
                ops.append(dist.P2POp(dist.irecv, left, prev, group))
            if not (clamp_edges and first):
                ops.append(dist.P2POp(dist.isend, x[:halo], prev, group))
            if not (clamp_edges and last):
                ops.append(dist.P2POp(dist.irecv, right, nxt, group))
            for op in ops:
                counts["send" if op.op is dist.isend else "recv"] += 1
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if clamp_edges:
            if idx == 0:
                left = x[:1].expand_as(left)
            if idx == n - 1:
                right = x[-1:].expand_as(right)
        return left, right

    # deep halo: the window is wider than the local shard
    full = x
    if n > 1:
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=mesh.group(axis))
        counts["all_gather"] += 1
        full = torch.cat(parts)
    total = n * L
    start = idx * L
    li = torch.arange(-halo, 0, device=x.device) + start
    ri = torch.arange(0, halo, device=x.device) + start + L
    if clamp_edges:
        li, ri = li.clamp(0, total - 1), ri.clamp(0, total - 1)
    else:
        li, ri = li % total, ri % total
    return full[li], full[ri]


def make_sharded_window_step(mesh: Mesh, loss_frames: Callable,
                             optimizer: Adam, window: int, n_views: int,
                             n_iters: int = 1):
    """Build the SPMD step of frame-parallel window stylization.

    Args:
      mesh: (frames, views) mesh from :func:`~nfs_tpu_torch.parallel.mesh.
        make_mesh`; the step runs on a rank that holds a shard.
      loss_frames: (params (L, ...), d (L, *spatial), vels_pad (L + 2W,
        *spatial, ndim) or None, views (L, nv_local, C) or None, aux) ->
        scalar: the sum over the L local frames of each frame's partial
        loss under this rank's views. Frame i's velocity window (global
        frames t-W .. t+W-1) is ``vels_pad[i : i + 2W]``. It must weight
        its partial losses so that SUMMING them over the view shards gives
        the full per-frame losses.
      optimizer: the port's :class:`~nfs_tpu_torch.styler.octave.Adam`.
      window: temporal half-width W (halo depth in frames).
      n_views: views per frame; each views rank takes n_views / views.
      n_iters: Adam iterations per call.

    Returns:
      step(params, opt_state, d, vels, pool, view_idx, aux, it0=0) ->
      (params, opt_state, losses), on the local shard: params, d and vels
      (sim velocities, or None without a window) hold this rank's L
      frames; ``pool`` is the (P, n_views, C) view pool (C = 2 angles, or
      3 with a per-view weight column), or None where the loss takes no
      views (2D); ``view_idx`` (L, >= it0 + n_iters) pool indices, of
      which iteration i takes column ``it0 + i``; ``losses`` is the
      (n_iters,) per-iteration mean loss over all frames of the mesh. The
      collectives of the last call are counted in ``step.collectives``.
    """
    f_shards = mesh.shape["frames"]
    v_shards = mesh.shape["views"]
    if n_views % v_shards != 0:
        raise ValueError(
            f"n_views={n_views} must divide the views mesh axis "
            f"({v_shards}); pad the view pool with weight-0 views "
            f"(ParallelSequenceStyler does this automatically)")
    nv_local = n_views // v_shards

    def step(params, opt_state, d, vels, pool, view_idx, aux, it0: int = 0):
        counts = _new_counts()
        vels_pad = None
        if window > 0:
            left, right = halo_exchange(vels, window, mesh, "frames",
                                        counts=counts)
            vels_pad = torch.cat([left, vels, right])
        L = d.shape[0]
        v0 = mesh.view_idx * nv_local
        losses = []
        for i in range(n_iters):
            views = None
            if pool is not None:
                views = pool[view_idx[:, it0 + i]][:, v0:v0 + nv_local]
            loss, grad = value_and_grad(
                lambda p: loss_frames(p, d, vels_pad, views, aux), params)
            if mesh.distributed:
                # the views ranks' partial gradients and losses, summed
                # in one buffer
                buf = torch.cat([grad.reshape(-1),
                                 loss.detach().reshape(1).to(grad.dtype)])
                dist.all_reduce(buf, group=mesh.views_group)
                counts["all_reduce"] += 1
                grad, loss = buf[:-1].view_as(grad), buf[-1]
            updates, opt_state = optimizer.update(grad, opt_state)
            params = (params + updates).detach()
            losses.append(loss.detach().to(torch.float32).reshape(()))
        # the sum of the FULL per-frame losses over the local frames; the
        # frames axis sums them over the whole sequence
        losses = torch.stack(losses)
        if mesh.distributed:
            dist.all_reduce(losses, group=mesh.frames_group)
            counts["all_reduce"] += 1
        step.collectives = counts
        return params, opt_state, losses / (L * f_shards)

    step.collectives = _new_counts()
    return step


# ------------------------------------------------------------------ #
# volumes split over an axis of the mesh
# ------------------------------------------------------------------ #

def _split(n_rows: int, mesh: Mesh, mesh_axis: str) -> Tuple[int, int]:
    """(rows per rank, this rank's first row) of an axis of ``n_rows``
    split over ``mesh_axis``; the rows must divide, as
    ``jax.device_put`` demands of a NamedSharding."""
    n = mesh.size(mesh_axis)
    if n_rows % n:
        raise ValueError(
            f"an axis of {n_rows} cannot be split evenly over the "
            f"{mesh_axis!r} mesh axis of {n} ranks")
    h = n_rows // n
    return h, mesh.axis_index(mesh_axis) * h


def own(x: torch.Tensor) -> torch.Tensor:
    """``x`` in storage of its own: a part of a volume that keeps no
    reference to the whole (a view would hold all of it allocated)."""
    return x.clone(memory_format=torch.contiguous_format)


def shard_volume(d, mesh: Mesh, axis: int = -1,
                 mesh_axis: str = "views") -> torch.Tensor:
    """This rank's part of a volume split over ``mesh_axis`` along array
    ``axis`` (every rank passes the whole volume, an array or tensor), in
    storage of its own: the counterpart of the JAX package's
    NamedSharding placement, whose shard a device holds."""
    d = torch.as_tensor(d)
    axis %= d.ndim
    h, start = _split(d.shape[axis], mesh, mesh_axis)
    return own(d.narrow(axis, start, h))


def gather_volume(x: torch.Tensor, mesh: Mesh, axis: int = -1,
                  mesh_axis: str = "views",
                  counts: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The whole volume from every rank's part along ``axis`` (the
    inverse of :func:`shard_volume`), on every rank of ``mesh_axis``."""
    axis %= x.ndim
    if not mesh.distributed or mesh.size(mesh_axis) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size(mesh_axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(mesh_axis))
    if counts is not None:
        counts["all_gather"] += 1
    return torch.cat(parts, dim=axis)


class SlabRing(NamedTuple):
    """A slab's place among the ``n`` slabs of one volume, and how it
    trades edge rows with its neighbours: ``exchange(to_below, to_above,
    like)`` sends ``to_below`` to slab ``idx - 1`` and ``to_above`` to
    slab ``idx + 1`` (where they exist) and returns what they sent this
    way, ``(from_below, from_above)``, each shaped as ``like``, None where
    there is no neighbour. :func:`mesh_ring` exchanges between the ranks
    of a mesh's space axis; ``parallel.spatial.run_slabs`` between slabs
    run one after another in one process."""

    n: int
    idx: int
    exchange: Optional[Callable] = None


def mesh_ring(mesh: Mesh, counts: Dict[str, int]) -> SlabRing:
    """This rank's :class:`SlabRing` on the space axis of ``mesh``: one
    ``batch_isend_irecv`` with each neighbouring rank, counted in
    ``counts``."""
    n, idx = mesh.size("space"), mesh.space_idx
    ranks = mesh.axis_ranks("space") if n > 1 else None
    group = mesh.group("space")

    def exchange(to_below, to_above, like):
        def buf():
            return torch.empty(like.shape, dtype=like.dtype,
                               device=like.device)

        from_below = buf() if idx > 0 else None
        from_above = buf() if idx < n - 1 else None
        ops = []
        if idx > 0:
            ops.append(dist.P2POp(dist.isend, to_below.contiguous(),
                                  ranks[idx - 1], group))
            ops.append(dist.P2POp(dist.irecv, from_below, ranks[idx - 1],
                                  group))
        if idx < n - 1:
            ops.append(dist.P2POp(dist.isend, to_above.contiguous(),
                                  ranks[idx + 1], group))
            ops.append(dist.P2POp(dist.irecv, from_above, ranks[idx + 1],
                                  group))
        for op in ops:
            counts["send" if op.op is dist.isend else "recv"] += 1
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_below, from_above

    return SlabRing(n, idx, exchange)


def _halo_widths(halo: int, ring: SlabRing) -> Tuple[int, int]:
    """(rows below, rows above) that a slab takes from its neighbours:
    none past the volume's edges, where the slab's own bound is the
    volume's."""
    return ((halo if ring.idx > 0 else 0),
            (halo if ring.idx < ring.n - 1 else 0))


def crop_slab(x: torch.Tensor, below: int, above: int,
              axis: int) -> torch.Tensor:
    """The slab of one padded with ``below`` and ``above`` rows along
    ``axis``, in storage of its own."""
    if not below and not above:
        return x
    return own(x.narrow(axis, below, x.shape[axis] - below - above))


class SlabHalo(torch.autograd.Function):
    """``SlabHalo.apply(x, halo, ring, axis)``: a slab along ``axis``
    with ``halo`` rows of each neighbouring slab of ``ring`` (a
    :class:`SlabRing`) appended, none past the volume's edges (a slab
    must hold at least ``halo`` rows). The backward sends the gradient of
    those rows back to the slab that owns them, which adds it onto its
    edge rows: the adjoint of the halo."""

    @staticmethod
    def forward(ctx, x, halo, ring, axis):
        below, above = _halo_widths(halo, ring)
        ctx.geometry = (below, above, axis, ring)
        if ring.n == 1:
            return x
        h = x.shape[axis]
        if h < halo:
            raise ValueError(f"a slab of {h} rows cannot take a halo of "
                             f"{halo} rows from one neighbour")
        rows_below, rows_above = ring.exchange(
            x.narrow(axis, 0, halo), x.narrow(axis, h - halo, halo),
            x.narrow(axis, 0, halo))
        return torch.cat([t for t in (rows_below, x, rows_above)
                          if t is not None], dim=axis)

    @staticmethod
    def backward(ctx, g):
        below, above, axis, ring = ctx.geometry
        if ring.n == 1:
            return g, None, None, None
        out = crop_slab(g, below, above, axis)
        from_below, from_above = ring.exchange(
            g.narrow(axis, 0, below) if below else None,
            g.narrow(axis, g.shape[axis] - above, above) if above else None,
            g.narrow(axis, 0, below or above))
        # the neighbours' gradients of the rows they took as halo
        if from_below is not None:
            out.narrow(axis, 0, below).add_(from_below)
        if from_above is not None:
            out.narrow(axis, out.shape[axis] - above, above).add_(from_above)
        return out, None, None, None


class SlabGather(torch.autograd.Function):
    """``SlabGather.apply(x, mesh, axis, counts, replicated)``: the whole
    volume from the slabs of the space axis, on every rank of it.

    ``replicated=True`` is for a volume that every rank of the space axis
    then puts through the same computation to the same loss (the render,
    the features and the loss of every rank are the same): each rank's
    gradient with respect to the volume is then the whole gradient, and
    the backward is its slice to the rank's own slab. Summing it over
    the ranks would multiply it by their number. ``replicated=False`` is
    for a volume of which each rank then keeps only its own part (the
    exact advection): the gradients are summed over the ranks before the
    slice."""

    @staticmethod
    def forward(ctx, x, mesh, axis, counts, replicated):
        ctx.geometry = (x.shape[axis], axis, mesh, counts, replicated)
        return gather_volume(x, mesh, axis, "space", counts)

    @staticmethod
    def backward(ctx, g):
        h, axis, mesh, counts, replicated = ctx.geometry
        if mesh.size("space") == 1:
            return g, None, None, None, None
        if not replicated:
            g = g.contiguous()
            dist.all_reduce(g, group=mesh.group("space"))
            counts["all_reduce"] += 1
        return (own(g.narrow(axis, mesh.space_idx * h, h)), None, None,
                None, None)
