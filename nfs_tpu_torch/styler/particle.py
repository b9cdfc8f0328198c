"""LNST particle stylization engine (counterpart of
``nfs_tpu/styler/particle.py``; LNST arXiv:2005.00803).

Optimization variables are per-particle attributes (LNST §4): position
offsets ``dx``, density multipliers ``ddens`` and/or colours ``color``.
The forward pipeline is splat(x + dx, dens) -> grid (and a
weight-normalized colour grid) -> render (multi-view raymarch for 3D, the
grid itself for 2D) -> VGG -> Gram / semantic losses, with gradients
flowing back through the differentiable splat to the particle
attributes. Sequences are stylized at keyframes and
the attributes interpolated along particle identity between them (LNST
§5, ``stylize_keyframes``).

Octaves shrink the splat grid (positions rescale, per-particle variables
persist). Per octave the splat takes one of three routes, as in the JAX
package:

- binned (``ops/binsplat.py``): particles are sorted into dense
  (K, cells) bins once per chunk of ``particle.rebin_every`` iterations,
  and every iteration splats the bins. For 3D B-spline grids with
  ``splat_impl`` 'auto' or 'binned_pallas' the splat is the window kernel
  pair K4/K5 (``splat_binned_window``; the plain versions on a CPU
  tensor), and colour the five-channel pair K4c/K5c
  (``splat_binned_color_window``): one pass of [density, colour(3),
  ones] whose last channel normalizes the colour. ``splat_impl='binned'``
  and 2D grids take the generic ``splat_binned``, colour as the same
  5-channel pass (``splat_binned_color``), as the JAX package runs its
  multi-channel XLA window. Bin capacities K come from one occupancy probe per
  frame with one host sync (``_octave_ks``), reused across frames until a
  frame parks too many particles.
- grid-space coarse octaves (``particle.coarse_mode='grid'`` with the
  density optimized): one splat of the octave's density, then a
  log-density field is optimized on the grid and folded into ``ddens``
  with one trilinear sample.
- flat: one ``index_add`` of every particle's taps (``ops/splat.py``),
  for other kernels or supports, or when the bins would not fit.

Every route runs a keyframe batch, a leading B on the particles, the
params and the views; one frame is a batch of one. The keyframe-parallel
engine (``parallel/particles.py``) runs B keyframes as one program: one
binning, one splat and one render per iteration for all of them, VGG
over all their views, (B,) losses.

The JAX package keeps the binned chunk state in the TPU kernels' shifted,
tile-rounded layout when they run (``binned_layout='auto'``). That layout
exists for the TPU's (8, 128) tiling and has no counterpart here:
``binned_layout`` 'auto' and 'slots' both mean the slot layout, whose
dense region the kernels read as a view.

On a GPU, ``stylize_keyframes`` on a 3D grid replays the Adam iteration
of each grid-space coarse octave and of each density-only binned chunk
through K4/K5 as a CUDA graph once the styler has run its key eagerly
(``styler/octave.py`` ``_OctaveGraphs``; :meth:`ParticleStyler._graphed`
says where), with the eager loop's bits; the rebin, the coarse octave's
splat and every other route stay eager.

Random draws come from an explicit ``torch.Generator``; an optional
``view_schedule`` of view-pool indices replays another run's draws. A 2D
grid is its own image and draws no views.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nfs_tpu_torch.core.config import StyleConfig
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.ops.binsplat import (
    bin_count_stats, bin_particles, bucket_k, from_binned, padded_shape,
    splat_binned, splat_binned_color, to_binned)
from nfs_tpu_torch.ops.jaxgrad import jax_clip
from nfs_tpu_torch.ops.binsplat_kernels import (
    splat_binned_color_window, splat_binned_window)
from nfs_tpu_torch.ops.interp import grid_sample
from nfs_tpu_torch.ops.resize import octave_shapes
from nfs_tpu_torch.ops.splat import splat, splat_normalized
from nfs_tpu_torch.render.raymarch import (
    render2d, render_views, render_views_batch)
from nfs_tpu_torch.styler.base import StylerBase
from nfs_tpu_torch.styler.octave import (
    Adam, AdamState, _OctaveGraphs, run_octave)
from nfs_tpu_torch.utils.profiling import span

Param = Dict[str, torch.Tensor]


def _offset(dx: torch.Tensor, max_offset: float) -> torch.Tensor:
    """Position offset bounded to +-max_offset cells by a tanh limit."""
    return max_offset * torch.tanh(dx / max_offset)


def _dens_scale(ddens: torch.Tensor, max_log: Optional[float]
                ) -> torch.Tensor:
    """Multiplicative density factor exp(ddens), optionally bounded to
    exp(+-max_log) by a tanh limit (particle.max_log_dens)."""
    if max_log is None:
        return torch.exp(ddens)
    return torch.exp(max_log * torch.tanh(ddens / max_log))


def _uses_window(pc, shape) -> bool:
    """Whether the binned splat goes through the window kernels, K4/K5
    for density and K4c/K5c for colour: 3D B-spline with splat_impl
    'auto' or 'binned_pallas' (where the JAX package picks its Pallas
    kernels on a TPU)."""
    return (pc.splat_impl in ("auto", "binned_pallas") and len(shape) == 3
            and pc.kernel == "bspline")


def _octave_max_counts(p, shps, base: float, kernel="bspline"):
    """Per-octave bin stats on the device: row o = [max count,
    parked(1..16)] for octave shape o (feeds the K-budget selection). A
    (B, N, dim) keyframe stack gives (B, octaves, 17) in one pass."""
    out = torch.stack([bin_count_stats(p * (s[0] / base), s, kernel)
                       for s in shps])
    return out if p.ndim == 2 else out.transpose(0, 1)


def _sample_fields(g: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Each keyframe's field at its own points in one ``grid_sample``:
    (B, *shape) fields at (B, N, dim) coordinates -> (B, N). The keyframe
    is a leading integer coordinate, whose second corner carries weight
    0."""
    B, n = coords.shape[:2]
    kf = torch.arange(B, dtype=coords.dtype, device=coords.device)
    return grid_sample(g, torch.cat(
        [kf.view(B, 1, 1).expand(B, n, 1), coords], dim=-1))


def _capacities(ks):
    """(K, capacity) of a keyframe batch's bin capacities ``ks``: the
    layout's K and, where they differ, the (B,) capacities for
    ``bin_particles``."""
    return max(ks), (None if len(set(ks)) == 1 else torch.tensor(ks))


def _binned_chunk_core(param: Param, opt_state: Optional[AdamState], views,
                       data, loss_fn, optimizer: Adam, shape, ks,
                       scale: float, max_offset: float, has_dx: bool,
                       kernel: str = "bspline", return_state: bool = True,
                       graph=None):
    """One rebin + len(views) optimizer iterations of a keyframe batch
    (``data['x']`` (B, N, dim), every leaf with a leading B).

    Bins every keyframe at the chunk-start positions, keyframe b at the
    capacity ``ks[b]`` (``ops.binsplat.bin_particles``), moves param AND
    Adam state into the slot layout (Adam is elementwise, so permuting
    its moments with the params is exact), runs the steps (run_octave, or
    with ``graph``, an ``_OctaveGraphs`` and a key, that key's CUDA graph
    replayed), and moves both back to canonical order. ``opt_state=None``
    starts Adam in the slot layout; ``return_state=False`` skips moving
    the state back. The loss is (B,) per-keyframe losses, whose sum has no
    cross-keyframe term, so each keyframe gets its own gradient. Returns
    the losses (steps, B), as run_octave stacks them, and the parked
    counts (B,).
    """
    x, dens = data["x"], data["dens"]
    n = x.shape[1]
    K, capacity = _capacities(ks)
    with span("nfs.splat"):
        with torch.no_grad():
            p = (x + _offset(param["dx"], max_offset)) * scale if has_dx \
                else x * scale
        bn = bin_particles(p, shape, K, kernel=kernel, capacity=capacity)
        n_slots = bn.valid.shape[-1]
        # the loss reads the binned particles alone: a graph's data holds
        # no keyframe's own objects
        data_b = {k: v for k, v in data.items() if k not in ("x", "dens")}
        data_b.update(xb=to_binned(bn, x), densb=to_binned(bn, dens),
                      valid=bn.valid)

    def to_b(tree):     # canonical (B, N, ...) leaves -> binned
        with span("nfs.splat"):
            return {k: to_binned(bn, v)
                    if v.ndim in (2, 3) and v.shape[1] == n else v
                    for k, v in tree.items()}

    def from_b(tree):   # binned (slot-minor) leaves -> canonical
        return {k: from_binned(bn, v)
                if v.ndim in (2, 3) and v.shape[-1] == n_slots + n
                else v for k, v in tree.items()}

    def state_b(state):
        return None if state is None else AdamState(
            state.count, to_b(state.mu), to_b(state.nu))

    # slot tensors passed, not kept: run_octave frees each once replaced,
    # a graph's load once copied in
    if graph is None:
        param, losses, state = run_octave(
            to_b(param), loss_fn, data_b, views, len(views), optimizer.lr,
            optimizer=optimizer, init_opt_state=state_b(opt_state))
    else:
        graphs, key = graph
        g = graphs.load(key, to_b(param), data_b, views, len(views),
                        optimizer, moved=("xb", "densb", "valid"),
                        loss_shape=x.shape[:1],
                        init_opt_state=state_b(opt_state))
        # the replays read the graph's copies: the binning keeps its slots
        # alone, so no slot tensor is held twice while they run
        data_b, bn = None, bn._replace(valid=None)
        param, losses, state = graphs.replay(key, g, loss_fn, optimizer)
    with span("nfs.splat"):
        state = (AdamState(state.count, from_b(state.mu), from_b(state.nu))
                 if return_state else None)
        param = from_b(param)
    return param, state, losses, bn.n_overflow


class ParticleStyler(StylerBase):
    """Lagrangian (particle) stylizer for liquids and smoke (LNST), on a
    2D or 3D splat grid.

    Building one turns TF32 off for the process (``styler/base.py``).
    """

    def __init__(self, cfg: StyleConfig, grid_shape: Tuple[int, ...],
                 vgg_params=None, style_image: Optional[np.ndarray] = None,
                 content_image: Optional[np.ndarray] = None,
                 device="cuda"):
        self.grid_shape = tuple(grid_shape)
        super().__init__(cfg, vgg_params, style_image, content_image,
                         device)
        if len(self.grid_shape) == 2:   # the grid is the image: no views
            self.view_pool = None
        oc = cfg.optim
        self._loss_cache: Dict[Tuple, object] = {}
        # bin-capacity plans reused across frames; dropped whenever a
        # frame parks more particles than the warning threshold
        self._k_cache: Dict[Tuple, object] = {}
        self._optimizer = Adam(oc.lr, b1=oc.b1, b2=oc.b2)
        # the keyframe sequence's octaves as CUDA graphs (_graphed), and
        # whether a sequence's keyframe loop is running (stylize_keyframes)
        self._graphs = _OctaveGraphs()
        self._in_sequence = False

    # ---------------------------------------------------------------- #
    # loss pipeline: pure functions of (param, views, data)
    # ---------------------------------------------------------------- #

    def init_param(self, pset: ParticleSet) -> Param:
        pc = self.cfg.particle
        n, dim = pset.x.shape
        param = {}
        if pc.optimize_position:
            param["dx"] = torch.zeros((n, dim), dtype=torch.float32,
                                      device=self.device)
        if pc.optimize_density:
            param["ddens"] = torch.zeros((n,), dtype=torch.float32,
                                         device=self.device)
        if pc.optimize_color:
            param["color"] = (
                self._on_device(pset.color).clone()
                if pset.color is not None
                else torch.full((n, 3), 0.5, dtype=torch.float32,
                                device=self.device))
        return param

    def _splat_grids(self, param: Param, data, scale: float,
                     shape: Tuple[int, ...]):
        """param -> (density grid, colour grid or None) at octave
        resolution (positions scaled by `scale`), by the flat splat."""
        pc = self.cfg.particle
        x = data["x"]
        if "dx" in param:
            x = x + _offset(param["dx"], pc.max_offset)
        dens = data["dens"]
        if "ddens" in param:
            dens = dens * _dens_scale(param["ddens"], pc.max_log_dens)
        xs = x * scale
        d_grid = splat(xs, dens, shape, kernel=pc.kernel,
                       support=pc.support)
        # resolution-independent brightness: a coarse cell collects
        # (1/scale)^dim of the mass; the 3D raymarch steps 1/scale longer
        # per cell and the 2D image shows mass per area: scale^2 both
        c_grid = None
        if "color" in param:
            c_grid = splat_normalized(
                xs, jax_clip(param["color"], 0.0, 1.0), shape,
                kernel=pc.kernel, support=pc.support)
        return d_grid * (scale ** 2), c_grid

    def _octave_render_size(self, scale: float):
        """Per-octave render resolution (render.scale_with_octave); off
        when content features fix the size."""
        rc = self.cfg.render
        if not rc.scale_with_octave or self.content_feats is not None:
            return rc.render_size
        return tuple(
            max(rc.min_render_size, int(round(s * scale / 8)) * 8)
            for s in rc.render_size)

    def _render(self, d_grid: torch.Tensor, c_grid, views,
                render_size=None) -> torch.Tensor:
        """Density grid (and optional colour grid) -> (V, H, W, 3) images
        for the CNN: V views of a 3D grid, or the 2D grid itself. Without
        a colour grid the styler's transfer function colours the
        density."""
        rc = self.cfg.render
        render_size = render_size or rc.render_size
        tf = self.tf_nodes if c_grid is None else None
        if d_grid.ndim == 2:
            return render2d(d_grid, out_size=render_size, gamma=rc.gamma,
                            color=c_grid, tf_nodes=tf,
                            tf_max=rc.tf_max_density)[None]
        # a colour volume rotates with the density; the JAX package
        # composites it without the gamma curve
        return render_views(d_grid, views[:, 0], views[:, 1],
                            transmit=rc.transmit, out_size=render_size,
                            gamma=rc.gamma if c_grid is None else 1.0,
                            method=rc.rotation, tf_nodes=tf,
                            tf_max=rc.tf_max_density, color=c_grid)

    def _render_batch(self, d_grids: torch.Tensor, c_grids, views,
                      render_size) -> torch.Tensor:
        """:meth:`_render` of a keyframe batch -> (B, V, H, W, 3): each
        3D density grid under its own (V, 2) views (``views`` (B, V, 2))
        in one batched render; a colour volume or a 2D grid keyframe by
        keyframe."""
        rc = self.cfg.render
        if d_grids.ndim == 4 and c_grids is None:
            return render_views_batch(
                d_grids, views[..., 0], views[..., 1], transmit=rc.transmit,
                out_size=render_size, gamma=rc.gamma, method=rc.rotation,
                tf_nodes=self.tf_nodes, tf_max=rc.tf_max_density)
        return torch.stack([
            self._render(d, None if c_grids is None else c_grids[i],
                         None if views is None else views[i], render_size)
            for i, d in enumerate(d_grids)])

    def _splat_batch(self, param: Param, x, dens, scale: float, shape):
        """:meth:`_splat_grids` of each keyframe of a batch, stacked:
        (B, *shape) densities and (B, *shape, 3) colours or None."""
        with span("nfs.splat"):
            grids = [self._splat_grids({k: v[i] for k, v in param.items()},
                                       {"x": x[i], "dens": dens[i]}, scale,
                                       shape) for i in range(x.shape[0])]
            return (torch.stack([d for d, _ in grids]),
                    None if grids[0][1] is None
                    else torch.stack([c for _, c in grids]))

    def _get_loss_fn(self, shape: Tuple[int, ...], scale: float):
        """Loss of the flat-splat route: (B,) per-keyframe losses, the
        splat keyframe by keyframe."""
        rsize = self._octave_render_size(scale)
        sig = (shape, round(scale, 6), rsize)
        if sig in self._loss_cache:
            return self._loss_cache[sig]
        # the styler caches this closure, so it holds the styler weakly:
        # a dropped styler, its CUDA graphs' buffers with it, is freed at
        # once, not when the garbage collector finds the cycle
        styler = weakref.proxy(self)

        def loss_fn(param, views, data):
            d_grid, c_grid = styler._splat_batch(param, data["x"],
                                                 data["dens"], scale, shape)
            total = styler._image_losses(
                styler._render_batch(d_grid, c_grid, views, rsize), data)
            if "dx" in param:
                # keep offsets small (LNST regularizes position changes)
                total = total + 1e-3 * torch.mean(param["dx"] ** 2,
                                                  dim=(1, 2))
            return total

        self._loss_cache[sig] = loss_fn
        return loss_fn

    def _get_binned_loss_fn(self, shape: Tuple[int, ...], scale: float,
                            K: int):
        """Loss over the binned slot layout of a keyframe batch (leading
        B): (B,) per-keyframe losses, every splat and render one batched
        call and VGG one pass over the B * V images. Equals `_get_loss_fn`
        for the 'bspline' and 'linear' kernels at support 1. Density,
        colour and the colour's normalization share one 5-channel window
        pass."""
        rsize = self._octave_render_size(scale)
        pc = self.cfg.particle
        sig = ("binned", pc.splat_impl, pc.kernel, shape, round(scale, 6),
               K, rsize)
        if sig in self._loss_cache:
            return self._loss_cache[sig]
        window = _uses_window(pc, shape)
        styler = weakref.proxy(self)    # held weakly, as _get_loss_fn's

        def loss_fn(param_b, views, data_b):
            # binned leaves are slot-minor: xb/dx (B, dim, S), densb
            # (B, S), color (B, 3, S)
            xb, densb, valid = data_b["xb"], data_b["densb"], data_b["valid"]
            if "dx" in param_b:
                pb = (xb + _offset(param_b["dx"], pc.max_offset)) * scale
            else:
                pb = xb * scale
            dens_eff = densb
            if "ddens" in param_b:
                dens_eff = densb * _dens_scale(param_b["ddens"],
                                               pc.max_log_dens)
            c_grid = None
            if "color" in param_b and window:
                d_grid, c_grid = splat_binned_color_window(
                    pb, dens_eff, param_b["color"], valid, shape, K)
            elif "color" in param_b:
                d_grid, c_grid = splat_binned_color(
                    pb, dens_eff, param_b["color"], valid, shape, K,
                    kernel=pc.kernel)
            elif window:
                d_grid = splat_binned_window(pb, dens_eff, valid, shape, K)
            else:
                d_grid = splat_binned(pb, dens_eff, valid, shape, K,
                                      kernel=pc.kernel)
            d_grid = d_grid * (scale ** 2)
            total = styler._image_losses(
                styler._render_batch(d_grid, c_grid, views, rsize), data_b)
            if "dx" in param_b:
                # parked + dense slots hold every particle once and empty
                # slots are zero, so sum / (dim N) == the canonical mean;
                # the (B, dim, n_slots + N) offsets give dim and N
                dx = param_b["dx"]
                n_dx = float(dx.shape[-2] * (dx.shape[-1] - valid.shape[-1]))
                total = total + (1e-3 * torch.sum(dx ** 2, dim=(1, 2))
                                 / n_dx)
            return total

        self._loss_cache[sig] = loss_fn
        return loss_fn

    def _get_grid_loss_fn(self, shape: Tuple[int, ...], scale: float):
        """Loss of a grid-space coarse octave: log-density fields g
        (B, *shape) over the once-splatted octave densities, d* = base_d *
        exp(g), to (B,) losses."""
        rsize = self._octave_render_size(scale)
        sig = ("grid_coarse", shape, round(scale, 6), rsize)
        if sig in self._loss_cache:
            return self._loss_cache[sig]
        styler = weakref.proxy(self)    # held weakly, as _get_loss_fn's

        def loss_fn(g, views, data):
            d_grid = data["base_d"] * torch.exp(g)
            return styler._image_losses(
                styler._render_batch(d_grid, None, views, rsize), data)

        self._loss_cache[sig] = loss_fn
        return loss_fn

    @torch.no_grad()
    def _prep_splat(self, param: Param, x, dens, shape, scale: float,
                    ks) -> torch.Tensor:
        """The one splat of a grid-space coarse octave for a keyframe
        batch (x (B, N, dim), ``ks`` a bin capacity or None per keyframe)
        -> (B, *shape): binned in one pass (through K4 where the window
        kernels apply) when every keyframe has a capacity, else flat."""
        with span("nfs.splat"):
            pc = self.cfg.particle
            if None in ks:
                return self._splat_batch(param, x, dens, scale, shape)[0]
            if "dx" in param:
                x = x + _offset(param["dx"], pc.max_offset)
            if "ddens" in param:
                dens = dens * _dens_scale(param["ddens"], pc.max_log_dens)
            xs = x * scale
            K, capacity = _capacities(ks)
            bn = bin_particles(xs, shape, K, kernel=pc.kernel,
                               capacity=capacity)
            pb = to_binned(bn, xs)
            db = to_binned(bn, dens)
            if _uses_window(pc, shape):
                base_d = splat_binned_window(pb, db, bn.valid, shape, K)
            else:
                base_d = splat_binned(pb, db, bn.valid, shape, K,
                                      kernel=pc.kernel)
            return base_d * (scale ** 2)

    def _grid_coarse_octave(self, param: Param, data, views, shape,
                            scale: float, ks, callback=None):
        """One coarse octave of a keyframe batch in grid space, folded
        into per-particle ddens (one splat and one trilinear sample per
        octave): B fields in one run of Adam, elementwise. Returns the
        (B, iters) losses."""
        oc, pc = self.cfg.optim, self.cfg.particle
        shape = tuple(shape)
        base_d = self._prep_splat(param, data["x"], data["dens"], shape,
                                  scale, ks)
        gdata = {"pool": data["pool"], "vgg": data["vgg"],
                 "targets": data["targets"], "content": data.get("content"),
                 "base_d": base_d}
        loss_fn = self._get_grid_loss_fn(shape, scale)
        key = self._octave_key("coarse", shape, scale, base_d, oc.iters)
        if self._graphed(key):
            graph = self._graphs.load(
                key, torch.zeros_like(base_d), gdata, views, oc.iters,
                self._optimizer, moved=("base_d",),
                loss_shape=base_d.shape[:1])
            g, losses, _ = self._graphs.replay(
                key, graph, loss_fn, self._optimizer, oc.log_every,
                callback)
        else:
            g, losses, _ = run_octave(
                torch.zeros_like(base_d), loss_fn, gdata, views, oc.iters,
                oc.lr, log_every=oc.log_every, callback=callback,
                optimizer=self._optimizer)
            self._graphs.ran(key)
        if "ddens" in param:
            x = data["x"]
            if "dx" in param:
                x = x + _offset(param["dx"], pc.max_offset)
            param = dict(param, ddens=param["ddens"]
                         + _sample_fields(g, x * scale))
        return param, losses.T

    def _octave_ks(self, x, dx, shapes, kmaxes=None,
                   margin: int = 0) -> Optional[list]:
        """Bin capacities K for every octave from ONE occupancy probe and
        ONE host sync. None when the binned route does not apply at all;
        an entry is None where the slot budget is blown."""
        pc = self.cfg.particle
        if (pc.splat_impl not in ("auto", "binned", "binned_pallas")
                or pc.kernel not in ("bspline", "linear")
                or pc.support != 1.0):
            return None
        if kmaxes is None:
            with span("nfs.bin_plan"):
                p = x + dx if dx is not None else x
                with torch.no_grad():
                    kmaxes = _octave_max_counts(
                        p, tuple(tuple(s) for s in shapes),
                        float(self.grid_shape[0]), kernel=pc.kernel)
                with span("nfs.readback"):
                    kmaxes = kmaxes.cpu().numpy()
        kmaxes = np.asarray(kmaxes)
        if kmaxes.ndim == 1:   # per-octave scalar maxima
            kmaxes = kmaxes[:, None]
        budget_n = (int(pc.k_budget * x.shape[0]) if pc.k_budget else 0)
        ks = []
        for stats, shape in zip(kmaxes, shapes):
            # +1 headroom for within-chunk drift; `margin` for cross-frame
            # drift when the caller caches the plan
            need = int(stats[0]) + 1 + margin
            if budget_n >= 1 and len(stats) > 1:
                # K-budget: the smallest K parking <= budget_n particles
                ok = np.nonzero(np.asarray(stats[1:]) <= budget_n)[0]
                if ok.size:
                    need = min(need, int(ok[0]) + 1)
            K = bucket_k(need)
            if K < need:
                # occupancy beyond the bucket cap would park particles for
                # the whole octave: use the exact flat splat instead
                ks.append(None)
                continue
            n_slots = int(np.prod(padded_shape(shape))) * K
            ks.append(K if n_slots <= pc.max_bin_slots else None)
        return ks

    def _run_binned_octave(self, param: Param, data, views, shape,
                           scale: float, ks, callback=None):
        """Binned octave of a keyframe batch (``ks`` a bin capacity per
        keyframe, laid out at the largest): one rebin per chunk of
        `particle.rebin_every` iterations; the callback gets each chunk's
        mean loss. Returns (B, iters) losses and (B,) parked counts."""
        oc, pc = self.cfg.optim, self.cfg.particle
        shape, K = tuple(shape), max(ks)
        loss_fn = self._get_binned_loss_fn(shape, scale, K)
        has_dx = "dx" in param
        # the window kernels' density route alone is graphed: the colour
        # pass's metrics read its device time under the span
        # nfs.splat_color, which a replay would hide
        graphable = "color" not in param and _uses_window(pc, shape)
        # one bin layout's graphs per octave shape: a plan that changed K
        # drops the old layout's before this octave runs, eagerly or not
        self._graphs.drop(lambda k: k[:2] == ("binned", shape)
                          and k[2:4] != (K, self._leaves(param)))
        # Adam state is fresh per octave: the first chunk starts it in the
        # slot layout, the last one does not move it back
        opt_state = None
        chunk = max(1, pc.rebin_every)
        all_losses, overflows = [], []
        done = 0
        while done < oc.iters:
            nst = min(chunk, oc.iters - done)
            key = self._octave_key("binned", shape, scale, param, nst, K)
            graph = ((self._graphs, key)
                     if graphable and self._graphed(key) else None)
            param, opt_state, losses, n_over = _binned_chunk_core(
                param, opt_state, views[done:done + nst], data, loss_fn,
                self._optimizer, shape, ks, scale, pc.max_offset, has_dx,
                kernel=pc.kernel, return_state=done + nst < oc.iters,
                graph=graph)
            if graph is None:
                self._graphs.ran(key)
            done += nst
            all_losses.append(losses)
            overflows.append(n_over)  # stays on the device
            if callback is not None:
                with span("nfs.readback"):
                    mean = float(losses.mean())
                callback(done, mean)
        # (B, iters) as a view: one chunk's cat stays a plain device copy
        return (param, torch.cat(all_losses).T,
                torch.stack(overflows).amax(dim=0))

    @staticmethod
    def _leaves(param) -> tuple:
        """A param's leaf names and shapes (a tensor's shape)."""
        if isinstance(param, dict):
            return tuple((k, tuple(v.shape)) for k, v in param.items())
        return tuple(param.shape)

    def _octave_key(self, route: str, shape, scale: float, param,
                    iters: int, K: Optional[int] = None) -> tuple:
        """What makes one octave's (or binned chunk's) Adam iteration
        differ from another's other than its inputs' values, so that the
        graph of an iteration with this key replays for another
        (:class:`styler.octave._OctaveGraphs`): the route ('coarse' or
        'binned'), the octave shape, the bins' K, the param's leaves (the
        batch B with them), the scale and render size (the loss closure),
        the iterations run, Adam's hyper-parameters and cuDNN's
        deterministic switch, which is read where the iteration runs."""
        opt = self._optimizer
        return (route, tuple(shape), K, self._leaves(param), round(scale, 6),
                self._octave_render_size(scale), iters,
                (opt.lr, opt.b1, opt.b2, opt.eps),
                torch.backends.cudnn.deterministic)

    def _graphed(self, key) -> bool:
        """Whether an octave (or binned chunk) runs as a CUDA graph: on a
        GPU, for a 3D grid, in a keyframe sequence's loop
        (``stylize_keyframes``), with a key that is ready
        (:meth:`_OctaveGraphs.ready`: run eagerly once, in a sequence's
        first keyframe). ``stylize_frame`` alone and the keyframe-parallel
        engine never capture."""
        return (self._in_sequence and self.device.type == "cuda"
                and len(self.grid_shape) == 3 and self._graphs.ready(key))

    def _keyframe_views(self, generators, schedules, o: int):
        """Per-iteration (B, V, 2) view sets of octave ``o`` for a
        keyframe batch, keyframe b's from ``generators[b]`` or its
        ``schedules[b]`` row (``schedules`` None: every keyframe draws);
        None per iteration for a 2D grid (it is its own image)."""
        iters = self.cfg.optim.iters
        if len(self.grid_shape) == 2:
            return [None] * iters
        per_kf = [self._octave_views(
            gen, None if schedules is None else schedules[b][o], iters, 1)
            for b, gen in enumerate(generators)]
        return [torch.stack([kf[it][0] for kf in per_kf])
                for it in range(iters)]

    def _optimize_keyframes(self, param: Param, x, dens, plan,
                            generators, schedules=None, callback=None):
        """The octave loop of a keyframe batch: x (B, N, dim), dens
        (B, N), param leaves (B, N, ...), ``plan`` each keyframe's bin
        capacity per octave (None entries: not binned), keyframe b drawing
        its views from ``generators[b]`` (or ``schedules[b]``, (octave_n,
        iters) pool indices). Per octave: a grid-space coarse octave, the
        binned route when every keyframe has a capacity, else the flat
        splat. Returns (param, per-octave (B, iters) losses, (B, octaves)
        parked counts on the device)."""
        oc, pc = self.cfg.optim, self.cfg.particle
        shapes = [tuple(s) for s in octave_shapes(
            self.grid_shape, oc.octave_n, oc.octave_scale)]
        # grid-space coarse octaves: only the finest octave splats every
        # iteration
        grid_coarse = (pc.coarse_mode == "grid" and "ddens" in param
                       and len(shapes) > 1)
        data = {"x": x, "dens": dens, "pool": self.view_pool,
                "vgg": self.vgg_params, "targets": self.gram_targets,
                "content": self.content_feats}
        losses, overs = [], []
        for o, shape in enumerate(shapes):
            with span("nfs.octave"):
                scale = shape[0] / self.grid_shape[0]
                views = self._keyframe_views(generators, schedules, o)
                cb = None
                if callback is not None:
                    def cb(done, loss, _o=o):
                        callback(done, loss, octave=_o)
                ks = [kf_plan[o] for kf_plan in plan]
                n_over = torch.zeros(x.shape[0], dtype=torch.long,
                                     device=self.device)
                if grid_coarse and o < len(shapes) - 1:
                    param, ls = self._grid_coarse_octave(
                        param, data, views, shape, scale, ks, callback=cb)
                elif None not in ks:
                    param, ls, n_over = self._run_binned_octave(
                        param, data, views, shape, scale, ks, callback=cb)
                else:  # flat splat (other kernels or supports, huge K)
                    param, ls, _ = run_octave(
                        param, self._get_loss_fn(shape, scale), data, views,
                        oc.iters, oc.lr, log_every=oc.log_every, callback=cb,
                        optimizer=self._optimizer)
                    ls = ls.T
                losses.append(ls)
                overs.append(n_over)
        return param, losses, torch.stack(overs, dim=1)

    # ---------------------------------------------------------------- #
    # public API
    # ---------------------------------------------------------------- #

    def stylize_frame(self, pset: ParticleSet,
                      init_param: Optional[Param] = None,
                      generator: Optional[torch.Generator] = None,
                      callback=None, view_schedule=None):
        """Optimize per-particle attributes for one (key)frame.

        Args:
          pset: particles; arrays or tensors, moved to the device.
          init_param: warm start (a param dict of (N, ...) tensors).
          generator: CPU ``torch.Generator`` for the view draws; default
            seeded with ``cfg.seed``.
          callback: fn(done, mean_chunk_loss, octave=o).
          view_schedule: optional (octave_n, iters) view-pool indices that
            replace the generator's draws.

        Returns (stylized ParticleSet, param dict, info) with
        info = {'octave_losses': per-octave (iters,) tensors,
        'octave_overflow': parked particles per octave}.
        """
        cfg = self.cfg
        oc, pc = cfg.optim, cfg.particle
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(cfg.seed))
        x = self._on_device(pset.x)
        dens = (self._on_device(pset.dens) if pset.dens is not None
                else torch.ones(x.shape[0], dtype=torch.float32,
                                device=self.device))
        param = ({k: self._on_device(v) for k, v in init_param.items()}
                 if init_param is not None
                 else self.init_param(ParticleSet(x=x, dens=dens,
                                                  color=pset.color)))
        shapes = octave_shapes(self.grid_shape, oc.octave_n,
                               oc.octave_scale)
        # the coarse octaves' one grid-space splat runs binned too when a
        # capacity fits, so every octave is probed
        ksig = (x.shape[0], tuple(tuple(s) for s in shapes), "dx" in param,
                pc.kernel, pc.splat_impl, pc.support)
        if ksig in self._k_cache:
            ks = self._k_cache[ksig]
        else:
            dx_now = None
            if "dx" in param:
                dx_now = _offset(param["dx"], pc.max_offset)
            # margin 2: the plan is reused across frames
            ks = self._octave_ks(x, dx_now, shapes, margin=2)
            self._k_cache[ksig] = ks
        # one frame is a keyframe batch of one
        param, losses, overs = self._optimize_keyframes(
            {k: v[None] for k, v in param.items()}, x[None], dens[None],
            [ks if ks is not None else [None] * len(shapes)], [generator],
            None if view_schedule is None else [view_schedule], callback)
        param = {k: v[0] for k, v in param.items()}
        # one sync per frame: parked particles are left out of the splat
        # until the next rebin, so a crowded frame must be visible. With a
        # K-budget, parking up to the budget is the deal; the threshold is
        # 4x the budget (drift headroom)
        with span("nfs.readback"):
            overflow = [int(v) for v in overs[0].cpu()]
        info = {"octave_losses": [ls[0] for ls in losses],
                "octave_overflow": overflow}
        over_thresh = 4 * (int(pc.k_budget * x.shape[0])
                           if pc.k_budget else 0)
        if max(info["octave_overflow"]) > over_thresh:
            # the next frame re-probes occupancy
            self._k_cache.pop(ksig, None)
            warnings.warn(
                f"binned splat parked {max(info['octave_overflow'])} "
                f"overflow particles (per octave: "
                f"{info['octave_overflow']}); they were excluded from the "
                f"splat between rebins (the next frame re-probes bin "
                f"capacity). Consider particle.rebin_every lower or "
                f"splat_impl='flat'.", stacklevel=2)

        return self.apply_param(pset, param), param, info

    @torch.no_grad()
    def apply_param(self, pset: ParticleSet, param: Param) -> ParticleSet:
        """Apply an optimized attribute dict to a particle set."""
        pc = self.cfg.particle
        x = self._on_device(pset.x)
        dens = (self._on_device(pset.dens) if pset.dens is not None
                else torch.ones(x.shape[0], dtype=torch.float32,
                                device=self.device))
        if "dx" in param:
            x = x + _offset(param["dx"], pc.max_offset)
        if "ddens" in param:
            dens = dens * _dens_scale(param["ddens"], pc.max_log_dens)
        return ParticleSet(x=x, dens=dens,
                           color=param.get("color", pset.color),
                           vel=pset.vel)

    @torch.no_grad()
    def rasterize(self, pset: ParticleSet) -> torch.Tensor:
        """Splat a (stylized) particle set to the full-res density grid."""
        pc = self.cfg.particle
        x = self._on_device(pset.x)
        dens = (self._on_device(pset.dens) if pset.dens is not None
                else torch.ones(x.shape[0], dtype=torch.float32,
                                device=self.device))
        return splat(x, dens, self.grid_shape, kernel=pc.kernel,
                     support=pc.support)

    def stylize_keyframes(self, psets, generator=None, callback=None,
                          view_schedule=None):
        """LNST §5 sequence flow: optimize at keyframes (stride
        particle.keyframe_stride, plus the last frame), each warm-started
        from the previous keyframe's attributes, and interpolate the
        attributes in between.

        Args:
          psets: per-frame ParticleSets with STABLE particle identity.
          generator: CPU ``torch.Generator`` for every keyframe's view
            draws, in turn; default seeded with ``cfg.seed``.
          view_schedule: optional (n_keyframes, octave_n, iters) pool
            indices.

        Yields (frame_index, stylized ParticleSet) for every frame.
        """
        T = len(psets)
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(self.cfg.seed))
        keyframes = keyframe_indices(T, self.cfg.particle.keyframe_stride)
        params = {}
        prev = None
        self.last_keyframe_infos = {}
        # a keyframe's octaves may run as CUDA graphs (_graphed): the first
        # keyframe runs each key eagerly, the next ones capture it
        self._in_sequence = True
        try:
            for i, kf in enumerate(keyframes):
                with span("nfs.frame", {"frame": kf}):
                    _, p, kf_info = self.stylize_frame(
                        psets[kf], init_param=prev, generator=generator,
                        callback=callback,
                        view_schedule=(None if view_schedule is None
                                       else view_schedule[i]))
                    params[kf] = p
                    self.last_keyframe_infos[kf] = kf_info
                    prev = {k: v.clone() for k, v in p.items()}
        finally:
            self._in_sequence = False
        yield from interp_sequence(
            psets, keyframes, params, float(self.cfg.particle.max_offset),
            apply_fn=self.apply_param,
            max_log_dens=self.cfg.particle.max_log_dens)


def interpolate_attrs(param0: Param, param1: Param, alpha: float) -> Param:
    """Linear keyframe interpolation of per-particle attribute dicts."""
    return {k: (1 - alpha) * param0[k] + alpha * param1[k] for k in param0}


def keyframe_indices(T: int, stride: int):
    """Keyframe schedule: every `stride` frames plus the final frame."""
    kfs = list(range(0, T, max(1, stride)))
    if kfs[-1] != T - 1:
        kfs.append(T - 1)
    return kfs


def interp_sequence(psets, keyframes, params, max_offset: float, apply_fn,
                    max_log_dens=None):
    """Keyframe interpolation segment by segment (LNST §5, attributes
    interpolated along particle identity), on the device of the keyframe
    params. Yields (t, stylized ParticleSet) for every frame index."""
    if len(keyframes) == 1:
        yield 0, apply_fn(psets[0], params[keyframes[0]])
        return
    device = next(iter(params[keyframes[0]].values())).device

    def on_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    for k0, k1 in zip(keyframes[:-1], keyframes[1:]):
        last = k1 == keyframes[-1]
        ts = list(range(k0, k1 + 1 if last else k1))
        with span("nfs.interp", {"frames": f"{ts[0]}-{ts[-1]}"}):
            alphas = torch.tensor([(t - k0) / (k1 - k0) for t in ts],
                                  dtype=torch.float32, device=device)
            x = torch.stack([on_dev(psets[t].x) for t in ts])
            n = x.shape[1]
            dens = torch.stack([
                on_dev(psets[t].dens) if psets[t].dens is not None
                else torch.ones(n, dtype=torch.float32, device=device)
                for t in ts])
            xo, do, co = _interp_apply_segment(
                params[k0], params[k1], alphas, x, dens, max_offset,
                max_log_dens)
        for i, t in enumerate(ts):
            color = co[i] if co is not None else psets[t].color
            yield t, ParticleSet(x=xo[i], dens=do[i], color=color,
                                 vel=psets[t].vel)


@torch.no_grad()
def _interp_apply_segment(p0: Param, p1: Param, alphas: torch.Tensor,
                          x: torch.Tensor, dens: torch.Tensor,
                          max_offset: float, max_log_dens=None):
    """Keyframe-segment interpolation + attribute application: lerps the
    two keyframe params at every alpha and applies them to the segment's
    stacked (m, n, 3) positions and (m, n) densities."""
    def lerp(u, v):
        a = alphas.reshape((-1,) + (1,) * u.ndim)
        return (1.0 - a) * u[None] + a * v[None]

    p = {k: lerp(p0[k], p1[k]) for k in p0}
    if "dx" in p:
        x = x + _offset(p["dx"], max_offset)
    if "ddens" in p:
        dens = dens * _dens_scale(p["ddens"], max_log_dens)
    return x, dens, p.get("color")


def param_to_numpy(param: Param) -> Dict[str, np.ndarray]:
    """Param dict -> numpy dict of (N, ...) arrays, the JAX package's keys."""
    return {k: v.detach().cpu().numpy() for k, v in param.items()}


def param_from_numpy(param, device="cpu") -> Param:
    """Numpy (or JAX-array) dict of (N, ...) arrays -> param dict."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in param.items()}
