"""Spatial sharding of a frame's volume over the ``space`` axis of a mesh
of ranks (counterpart of ``nfs_tpu/parallel/spatial.py``): for volumes
whose optimization state outgrows one GPU.

The JAX package shards the volume over a ``space`` mesh axis and lets
GSPMD insert the collectives. torch has no partitioner, so here each
rank holds its y-slab and the collectives are written out
(``parallel/sharding.py``):

- **state**: the density, the parameter (density, or velocity with 3
  channels), Adam's m and v, the gradient and the sim velocities are
  split along y (``SPACE_AXIS = 1`` of a (D, H, W) volume; the axis can
  be chosen): rank s holds rows [s h, (s + 1) h), h = H / space. Adam is
  elementwise, so it runs on the slab with no communication;
- **advection** (the window taps, the velocity parameterization): the
  slab takes R = ceil(max_disp) + 1 real rows of each neighbouring slab
  (:class:`~nfs_tpu_torch.parallel.sharding.SlabHalo`; none past the
  volume's edges, where the slab's bound is the volume's, so the clamp
  and its 0.5 tie gradient fall where they fall in the whole volume) and
  its velocity R rows of zeros; K1-K3 (K3b with ``FUSED_BWD``) run
  unchanged on the padded slab, whose interior backtraces never reach its
  bounds, and the output is cropped back to the slab. The backward sends
  K2's gradient of the halo rows to their owners, which add it onto their
  edge rows; K3's velocity gradient is per output cell and needs nothing.
  The slab's y-displacements are rounded to the whole volume's
  coordinates (``advect_kernels.slab_displacement``), so every output
  cell is the whole volume's bit for bit. The exact path (max_disp None)
  has no bounded halo: it gathers the field and advects the whole volume;
- **render**: the phi elevation shear and the image resize mix y, so every
  rendered state is all-gathered into the whole volume first
  (:class:`~nfs_tpu_torch.parallel.sharding.SlabGather`). Every rank of
  the space axis then renders the same views, computes the same features
  and the same loss (the JAX package's "effectively replicated" render
  and VGG), so the gather's backward is the slice of the gradient to the
  rank's slab, and the loss and the TV term (taken on the gathered
  parameter) count once. The transient peak is one whole volume plus the
  unsharded render's activations, as in JAX;
- **octaves**: the antialiased resize mixes y, so at each octave boundary
  the parameter and the density are gathered, resized whole, and sliced
  again. An octave whose y size does not divide by the space axis, or
  whose slab is thinner than R (the halo would reach past one
  neighbour), runs replicated: every rank holds the whole volume and
  makes the same updates.

:class:`SpaceSlabs` holds these decisions for one stylization; on one
slab (no space mesh) each of its methods is the unsharded computation,
so the styler and the engine run every frame through it.
:func:`stylize_frame_spatial` runs ``GridStyler.stylize_frame`` on a
:func:`spatial_mesh` and returns the rank's slabs; :func:`gather_spatial`
fetches the whole volume. The composed (frames, views, space) engine is
``parallel/engine.py``'s. Launch one process per GPU (``torchrun``), as
for the other engines. :func:`run_slabs` runs the slabs of n ranks one
after another in one process, which is how one device checks the slab
advection.
"""

from __future__ import annotations

import itertools
import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nfs_tpu_torch.ops.advect import advect, advect_frames
from nfs_tpu_torch.parallel.mesh import Mesh, make_mesh
from nfs_tpu_torch.parallel.sharding import (
    SlabGather, SlabHalo, SlabRing, _halo_widths, _new_counts, crop_slab,
    gather_volume, mesh_ring, own, shard_volume)

SPACE_AXIS = 1  # volume axis sharded across the mesh (y; see module doc)


class SpaceSlabs:
    """The slabs of one stylization: what the styler and the engine call
    where a volume is resized, advected, rendered or regularized. Without
    a mesh (or on a space axis of one rank) there is one slab, the whole
    volume, and every method is the unsharded computation.

    ``mesh``: the ranks whose ``space`` axis holds the slabs (None: one
    slab, unless ``ring`` says otherwise); ``shape`` the whole volume's
    spatial shape at full resolution, ``axis`` its sharded spatial axis,
    ``halo`` the rows R the loss's bounded advections take from each
    neighbour (0 without any), and ``lead`` the leading batch axes of the
    states (0 for one frame, 1 for the engine's (L, *spatial) stacks). At
    an octave shape a state is a slab if :meth:`sharded` says so, else
    the whole volume. Collectives issued are counted in ``counts``.
    ``ring``: the slab's :class:`SlabRing` in place of the mesh's (the
    slabs :func:`run_slabs` runs in one process, which have no gather).
    """

    def __init__(self, mesh: Optional[Mesh] = None,
                 shape: Optional[Sequence[int]] = None,
                 axis: int = SPACE_AXIS, halo: int = 0, lead: int = 0,
                 counts: Optional[Dict[str, int]] = None,
                 ring: Optional[SlabRing] = None):
        self.mesh = mesh
        self.shape = None if shape is None else tuple(int(n) for n in shape)
        self.axis = axis if shape is None else axis % len(self.shape)
        self.halo = halo
        self.lead = lead
        self.counts = counts if counts is not None else _new_counts()
        if ring is None:
            ring = (mesh_ring(mesh, self.counts) if mesh is not None
                    else SlabRing(1, 0))
        self.ring = ring
        self.n, self.idx = ring.n, ring.idx

    def sharded(self, shape: Sequence[int], warn: bool = False,
                label: Optional[int] = None) -> bool:
        """Whether states at this octave shape are slabs: the sharded axis
        divides by the space axis into slabs of at least ``halo`` rows
        (always, for one slab). With ``warn`` a replicated octave says so
        (``label``: the array axis named in the warning)."""
        if self.n == 1:
            return True
        rows = shape[self.axis]
        dim = self.axis if label is None else label
        if rows % self.n:
            if warn:
                warnings.warn(
                    f"volume axis {dim} (size {rows}) is not divisible by "
                    f"the space mesh axis ({self.n}); this octave runs "
                    f"replicated (full volume per device). Pick shapes "
                    f"divisible by the space axis for the memory win.",
                    stacklevel=3)
            return False
        if rows // self.n < self.halo:
            if warn:
                warnings.warn(
                    f"volume axis {dim} (size {rows}) gives slabs of "
                    f"{rows // self.n} rows on the space mesh axis "
                    f"({self.n}), fewer than the {self.halo}-row advection "
                    f"halo; this octave runs replicated (full volume per "
                    f"device).", stacklevel=3)
            return False
        return True

    def octave(self, shape: Sequence[int], warn: bool = False,
               label: Optional[int] = None) -> "SpaceSlabs":
        """The slabs of the states at octave ``shape``: these, where the
        octave is sharded, else one slab, the whole volume, that every
        rank holds and updates identically (warned as :meth:`sharded`
        warns)."""
        if self.sharded(shape, warn, label):
            return self
        return SpaceSlabs(shape=self.shape, axis=self.axis, lead=self.lead)

    def _ax(self, lead: Optional[int]) -> int:
        return (self.lead if lead is None else lead) + self.axis

    def slab(self, x: torch.Tensor, lead: Optional[int] = None):
        """This rank's slab of a whole volume (no communication), in
        storage of its own."""
        if self.n == 1:
            return x
        ax = self._ax(lead)
        h = x.shape[ax] // self.n
        return own(x.narrow(ax, self.idx * h, h))

    def gather(self, x: torch.Tensor, lead: Optional[int] = None,
               replicated: bool = True) -> torch.Tensor:
        """The whole volume of a slab, differentiable
        (:class:`SlabGather`): for a state every rank then renders."""
        if self.n == 1:
            return x
        if self.mesh is None:
            raise ValueError("slabs without a mesh cannot be gathered")
        return SlabGather.apply(x, self.mesh, self._ax(lead), self.counts,
                                replicated)

    def resize(self, x: torch.Tensor, shape: Sequence[int],
               to_shape: Sequence[int],
               fn: Callable[[torch.Tensor], torch.Tensor],
               lead: Optional[int] = None) -> torch.Tensor:
        """A state at octave ``shape`` (a slab if sharded there) resized
        by ``fn`` (whole volume to whole volume at ``to_shape``), as a slab
        if sharded at ``to_shape``: gathered first, sliced after."""
        if tuple(shape) == tuple(to_shape):
            return x
        if self.n > 1 and self.sharded(shape):
            x = gather_volume(x, self.mesh, self._ax(lead), "space",
                              self.counts)
        x = fn(x)
        return self.slab(x, lead) if self.sharded(to_shape) else x

    def advect(self, field: torch.Tensor, vel: torch.Tensor,
               max_disp: Optional[float] = None, impl: str = "auto",
               lead: Optional[int] = None) -> torch.Tensor:
        """``ops.advect.advect`` of a slab (``advect_frames`` of a stack
        of slabs with ``lead`` 1): the bounded path on the slab padded
        with R = ceil(max_disp) + 1 rows of each neighbour, the exact path
        on the gathered volume."""
        lead = self.lead if lead is None else lead
        run = advect_frames if lead else advect
        if self.n == 1:
            return run(field, vel, max_disp=max_disp, impl=impl)
        ax = lead + self.axis
        h = field.shape[ax]
        if max_disp is None:
            # no bounded halo: the whole field, the velocity zero outside
            # the slab (only the slab's outputs are kept)
            full = self.gather(field, lead, replicated=False)
            pad = [0, 0] * (vel.ndim - ax - 1) + [
                self.idx * h, (self.n - 1 - self.idx) * h]
            out = run(full, F.pad(vel, pad), max_disp=None, impl=impl)
            return own(out.narrow(ax, self.idx * h, h))
        R = int(math.ceil(max_disp)) + 1
        below, above = _halo_widths(R, self.ring)
        field = SlabHalo.apply(field, R, self.ring, ax)
        vel = F.pad(vel, [0, 0] * (vel.ndim - ax - 1) + [below, above])
        out = run(field, vel, max_disp=max_disp, impl=impl,
                  origin=(self.axis, self.idx * h - below))
        return crop_slab(out, below, above, ax)

    def whole(self, x: torch.Tensor, lead: Optional[int] = None):
        """The whole volume of a slab, not differentiable: a result."""
        if self.n == 1:
            return x
        return gather_volume(x, self.mesh, self._ax(lead), "space",
                             self.counts)


def run_slabs(fn: Callable[[SlabRing], object], n: int,
              max_rounds: int = 8) -> List[object]:
    """``fn(ring)`` for each of the ``n`` slabs of one volume, one after
    another in one process with no process group, as ``n`` ranks would
    run it together; returns the ``n`` results. ``fn`` builds its
    :class:`SpaceSlabs` with ``ring=ring`` and may advect (halo exchanges,
    forward and backward), not gather.

    A slab's k-th exchange receives what its neighbours sent in their
    k-th exchange during the previous round (zeros in the first), so
    every slab is run again until what the slabs send repeats bit for
    bit: each slab has then received what concurrent ranks would have.
    One advection and its backward, with a given cotangent, take two
    rounds. Counters that ``fn`` raises (kernel launches) count every
    round; read them inside ``fn``."""
    before = None
    for _ in range(max_rounds):
        sent: Dict[Tuple[int, int, int], torch.Tensor] = {}
        results = []
        for s in range(n):
            calls = itertools.count()

            def exchange(to_below, to_above, like, s=s, calls=calls):
                k = next(calls)
                for dst, rows in ((s - 1, to_below), (s + 1, to_above)):
                    if 0 <= dst < n:
                        sent[(s, dst, k)] = rows.detach().clone()

                def recv(src):
                    if not 0 <= src < n:
                        return None
                    got = (before or {}).get((src, s, k))
                    return (torch.zeros_like(like) if got is None
                            else got.clone())

                return recv(s - 1), recv(s + 1)

            results.append(fn(SlabRing(n, s, exchange)))
        if before is not None and sent.keys() == before.keys() and all(
                torch.equal(sent[k], before[k]) for k in sent):
            return results
        before = sent
    raise RuntimeError(f"run_slabs: what the {n} slabs send still changed "
                       f"after {max_rounds} rounds")


def halo_rows(cfg, window: int) -> int:
    """Rows R a slab takes from each neighbour for the loss's bounded
    advections: ceil(max_disp) + 1 for the window taps, ceil(
    param_max_disp) + 1 for the velocity parameterization (0 for the
    exact path and without advection)."""
    oc = cfg.optim
    R = 0
    if window and oc.max_disp is not None:
        R = int(math.ceil(oc.max_disp)) + 1
    if oc.parameterization == "velocity" and oc.param_max_disp is not None:
        R = max(R, int(math.ceil(oc.param_max_disp)) + 1)
    return R


def spatial_mesh(n_devices: Optional[int] = None) -> Mesh:
    """(1, 1, n) mesh for spatial sharding; defaults to all ranks of the
    process group (every rank must call it, as :func:`make_mesh`)."""
    if n_devices is None:
        n_devices = (torch.distributed.get_world_size()
                     if torch.distributed.is_initialized() else 1)
    return make_mesh(1, 1, n_devices)


def shard_volume_spatial(d, mesh: Mesh, axis: int = SPACE_AXIS):
    """This rank's slab of a (D, H, W[, C]) volume along ``axis`` (every
    rank passes the whole volume). The axis length must divide by the
    space axis (ValueError otherwise, as ``jax.device_put`` refuses)."""
    return shard_volume(d, mesh, axis=axis, mesh_axis="space")


def gather_spatial(x: torch.Tensor, mesh: Mesh,
                   axis: int = SPACE_AXIS) -> torch.Tensor:
    """The whole volume from the slabs of the space axis, on every rank
    (the port's counterpart of fetching a sharded ``jax.Array``)."""
    return gather_volume(x, mesh, axis=axis, mesh_axis="space")


def replicate(tree, device):
    """A copy of every tensor of a pytree (dicts, lists, tuples) on
    ``device``: the constants every rank holds whole."""
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def prepare_spatial(styler, mesh: Mesh) -> None:
    """Put a styler's constants (view pool, VGG weights, Gram targets,
    content features) whole on the styler's device, this rank's.
    Idempotent. The advection kernels stay on: each rank runs them on its
    slab."""
    del mesh  # every rank holds the constants whole
    for name in ("view_pool", "vgg_params", "gram_targets",
                 "content_feats"):
        val = getattr(styler, name, None)
        if val is not None:
            setattr(styler, name, replicate(val, styler.device))


def sharded_param_init(styler, shape: Sequence[int], mesh: Mesh,
                       axis: int = SPACE_AXIS) -> torch.Tensor:
    """This rank's slab of a zero init param, so that the optimizer state
    is a slab from the first octave on."""
    return shard_volume_spatial(styler.init_param(tuple(shape)), mesh,
                                axis=axis)


def stylize_frame_spatial(styler, d, mesh: Mesh, axis: int = SPACE_AXIS,
                          **kwargs):
    """Spatially sharded single-frame stylization: the styler's
    ``stylize_frame`` octave loop on this rank's slab of ``d`` (every rank
    passes the whole frame; ``vels`` and ``init_param`` too, whole, in
    ``kwargs``), every rank of ``mesh``'s space axis calling it together.

    Returns (d_star, param, info) as ``stylize_frame``, d_star and param
    as this rank's slabs along ``axis`` (:func:`gather_spatial` fetches
    the whole volume); ``info['collectives']`` counts the collectives
    issued. In-frame checkpoints are not supported here.
    """
    if kwargs.get("checkpoint_path") is not None:
        raise ValueError("stylize_frame_spatial: in-frame checkpoints are "
                         "not supported on a space mesh")
    prepare_spatial(styler, mesh)
    d = torch.as_tensor(d)
    shape = tuple(d.shape)
    window = styler.cfg.optim.window if kwargs.get("vels") is not None \
        else 0
    space = SpaceSlabs(mesh, shape, axis=axis,
                       halo=halo_rows(styler.cfg, window))
    # the frame's state at full resolution: slabs where the finest octave
    # is sharded, else whole on every rank (sliced at the end)
    whole = not space.sharded(shape)
    if whole:
        shard_volume_spatial(d, mesh, axis)     # the same refusal

    def place(x, lead=0):
        # sliced where it lies (on the host for an array), so that the
        # device holds the slab alone
        if not whole:
            x = shard_volume_spatial(x, mesh, axis + lead)
        return styler._on_device(x)

    d = place(d)
    if kwargs.get("vels") is not None:
        kwargs["vels"] = place(kwargs["vels"], lead=1)
    init = kwargs.get("init_param")
    if init is None:
        init = styler.init_param(shape)
    if isinstance(init, dict):      # render.train_transfer: the tf whole
        init = dict(init, field=place(init["field"]))
    else:
        init = place(init)
    kwargs["init_param"] = init
    d_star, param, info = styler.stylize_frame(d, space=space, **kwargs)
    if whole:
        d_star = space.slab(d_star)
        param = (dict(param, field=space.slab(param["field"]))
                 if isinstance(param, dict) else space.slab(param))
    info["collectives"] = dict(space.counts)
    return d_star, param, info


def persistent_state_bytes(shape: Sequence[int],
                           parameterization: str = "density",
                           window_taps: int = 5) -> int:
    """Analytic per-frame persistent-state footprint (f32): density +
    param + Adam m/v + gradient + ~`window_taps` advection-window AD
    residuals -- the memory that spatial sharding divides by the mesh
    size (the transient gathers of the render are one volume each and do
    not persist)."""
    vol = int(np.prod(shape)) * 4
    chans = len(shape) if parameterization == "velocity" else 1
    return vol + (4 * chans) * vol + window_taps * vol
