"""Frame-parallel joint sequence stylization (counterpart of
``nfs_tpu/parallel/engine.py``; the north-star workload, a 200-frame
112x64x112 smoke sequence, on a mesh of GPUs).

Where :meth:`GridStyler.stylize_sequence` walks the frames one after
another with a recursive warm start (TNST §6), this engine optimizes ALL
frames JOINTLY: the per-frame stylization variables are split over the
``frames`` axis of a mesh of ranks, every Adam step evaluates every
frame's Gaussian-window transport loss (neighbour velocities fetched
through ring halos) and camera views split over the ``views`` axis with
the gradients summed by all_reduce. On one GPU (a (1, 1) mesh) it is one
program over all T frames: each advection tap is one batched launch of
K1 (and of K2 or K3 in the backward) for all local frames, and every
frame's window states and views go through VGG in one batch.

SPMD: every rank runs :meth:`ParallelSequenceStyler.stylize` on the whole
sequence, keeps its own frames, and returns the gathered result, as the
JAX call returns it. A frame's view draws depend only on the seed and the
frame's index in the sequence, so the result does not depend on the mesh.

On a composed (frames, views, space) mesh each frame's volume is also
split into y-slabs (x for 2D) over ``space`` (``parallel/spatial.py``):
params, Adam state, densities and sim velocities are slabs, each tap's
batched advection takes a halo of the neighbouring slabs, the window
states and the params are gathered whole for the render and the TV term,
the views all_reduce sums one slab's partial gradients, the frame halos
ride the ranks of one slab, and the result is gathered over space, then
over frames. An octave whose sharded axis does not divide by the space
axis (or gives slabs thinner than the advection halo) runs replicated
over space, with a warning, as the JAX engine keeps it frames-sharded
only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nfs_tpu_torch.features.losses import tv_loss
from nfs_tpu_torch.ops.resize import octave_shapes, resize_frames
from nfs_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from nfs_tpu_torch.parallel.sharding import (
    _new_counts, make_sharded_window_step)
from nfs_tpu_torch.parallel.spatial import SpaceSlabs, halo_rows
from nfs_tpu_torch.render.camera import poisson_view_pool
from nfs_tpu_torch.render.raymarch import render2d, render_views_batch
from nfs_tpu_torch.styler.grid import GridStyler
from nfs_tpu_torch.utils.profiling import span


class ParallelSequenceStyler:
    """Runs a :class:`GridStyler`'s loss pipeline through the sharded
    window step on a (frames, views[, space]) mesh."""

    def __init__(self, styler: GridStyler, mesh: Optional[Mesh] = None):
        self.styler = styler
        self.cfg = styler.cfg
        if mesh is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = make_mesh(*mesh_shape_for(world))
        self.mesh = mesh
        # collectives issued by the last stylize call, summed over its
        # steps and gathers
        self.last_collectives = _new_counts()

    # ------------------------------------------------------------- #

    def _apply_params(self, params, d, space: SpaceSlabs):
        """Every local frame's d* at once, on the slabs ``space`` (the
        velocity parameterization advects them in one batched call)."""
        oc = self.cfg.optim
        if oc.parameterization == "velocity":
            return space.advect(d, params, max_disp=oc.param_max_disp,
                                impl=oc.advect_impl)
        return d + params

    def _loss_frames(self, ndim: int, window: int, render_size,
                     space: SpaceSlabs):
        """The step's loss: the sum over the local frames of each frame's
        views-partial loss (``make_sharded_window_step``), on the octave's
        slabs ``space``, gathered whole for the render and the TV term
        (every rank of the space axis computes the same loss)."""
        styler, cfg = self.styler, self.cfg
        rc = cfg.render
        v_shards = self.mesh.shape["views"]
        weights = (styler._window_weights(window) if window else
                   torch.ones(1, device=styler.device))

        run = space.advect

        def loss_frames(params, d, vels_pad, views, aux):
            L = d.shape[0]
            d_star = self._apply_params(params, d, space)
            # all 2W+1 transported states of every local frame: each tap
            # advects the L frames in one batched call. Frame i's window
            # velocities are vels_pad[i : i + 2W]: forward taps take
            # vels_w[W + j - 1], backward taps -vels_w[W - j]
            states = [None] * (2 * window + 1)
            states[window] = d_star
            md, impl = cfg.optim.max_disp, cfg.optim.advect_impl
            d_j = d_star
            for j in range(1, window + 1):
                k = window + j - 1
                d_j = run(d_j, vels_pad[k:k + L], max_disp=md, impl=impl)
                states[window + j] = d_j
            d_j = d_star
            for j in range(1, window + 1):
                k = window - j
                d_j = run(d_j, -vels_pad[k:k + L], max_disp=md, impl=impl)
                states[window - j] = d_j
            P = len(states)
            st = space.gather(torch.stack(states, dim=1),
                              lead=2)                # (L, P, *spatial)
            if ndim == 3:
                # views (L, nv, 3): (theta, phi, weight); the weights carry
                # the padding mask and 1/n_views, so the weighted sums of
                # the view shards add up to the mean over the real views
                nv = views.shape[1]
                ang = views[:, None].expand(L, P, nv, views.shape[2])
                imgs = render_views_batch(
                    st.reshape((L * P,) + st.shape[2:]),
                    ang[..., 0].reshape(L * P, nv),
                    ang[..., 1].reshape(L * P, nv),
                    transmit=rc.transmit, out_size=render_size,
                    gamma=rc.gamma, method=rc.rotation,
                    tf_nodes=styler.tf_nodes, tf_max=rc.tf_max_density)
                pw = weights[None, :, None] * views[:, None, :, 2]
            else:
                # the grid is the image; every views rank renders it and
                # the loss is divided by the shard count below
                imgs = torch.stack([
                    render2d(s, out_size=render_size, gamma=rc.gamma,
                             tf_nodes=styler.tf_nodes,
                             tf_max=rc.tf_max_density)
                    for s in st.reshape((L * P,) + st.shape[2:])])
                pw = weights[None, :].expand(L, P)
            # every frame's window states and views through VGG in one
            # batch: sum over (frame, position, view) of weight * loss
            total = styler._image_loss_weighted(
                imgs.reshape((-1, 1) + imgs.shape[-3:]), pw.reshape(-1),
                aux)
            if cfg.loss.w_tv:
                tv = sum(tv_loss(p, ndim=ndim) for p in space.gather(params))
                # every views rank holds the whole param: each adds its
                # share, so that the views sum counts the term once
                total = total + cfg.loss.w_tv * tv / (
                    1 if ndim == 2 else v_shards)
            if ndim == 2:
                total = total / v_shards
            return total

        return loss_frames

    # ------------------------------------------------------------- #

    def _view_pool(self, n_views: int, nv_pad: int) -> torch.Tensor:
        """(P, nv_pad, 3) pool of (theta, phi, weight): the styler's
        Poisson pool (or one built for n_views), each view weighted
        1/n_views, padded with weight-0 copies of its first views up to
        a multiple of the views axis."""
        styler, rc = self.styler, self.cfg.render
        if styler.view_pool is not None \
                and styler.view_pool.shape[1] == n_views:
            pool = styler.view_pool
        else:
            pool = torch.from_numpy(poisson_view_pool(
                rc.view_pool, n_views, (rc.theta0, rc.theta1),
                (rc.phi0, rc.phi1), seed=self.cfg.seed)).to(styler.device)
        view_w = torch.full(pool.shape[:2] + (1,), 1.0 / n_views,
                            dtype=pool.dtype, device=pool.device)
        pool = torch.cat([pool, view_w], dim=-1)
        if nv_pad != n_views:
            pad = pool[:, :nv_pad - n_views].clone()
            pad[..., 2] = 0.0
            pool = torch.cat([pool, pad], dim=1)
        return pool

    def _view_draws(self, frames, pool_size: int, seed: int,
                    view_schedule):
        """(len(frames), octave_n, iters) pool indices of the given global
        frames: ``view_schedule`` rows (clamped to its last frame), or per
        frame, octave by octave, ``torch.randint(pool_size, (iters,))``
        from the frame's own generator (``GridStyler._frame_generator``'s
        seeding), so a frame draws the same views on every mesh."""
        oc = self.cfg.optim
        if view_schedule is not None:
            sched = np.asarray(view_schedule, dtype=np.int64)
            rows = np.minimum(np.asarray(frames), sched.shape[0] - 1)
            return torch.as_tensor(sched[rows].reshape(
                len(frames), oc.octave_n, oc.iters))
        out = torch.empty((len(frames), oc.octave_n, oc.iters),
                          dtype=torch.int64)
        for i, t in enumerate(frames):
            if self.cfg.render.fixed_view_schedule:
                gen = torch.Generator().manual_seed(seed)
            else:
                s = np.random.SeedSequence([seed, int(t)])
                gen = torch.Generator().manual_seed(
                    int(s.generate_state(1)[0]))
            for o in range(oc.octave_n):
                out[i, o] = torch.randint(pool_size, (oc.iters,),
                                          generator=gen)
        return out

    def _local(self, x, idx: np.ndarray, space: SpaceSlabs) -> torch.Tensor:
        """This rank's slabs on ``space`` of frames ``idx`` (indices into
        the sequence) of an array or tensor, sliced where they lie, as a
        float32 tensor on the styler's device."""
        if isinstance(x, torch.Tensor):
            x = x[torch.as_tensor(idx, device=x.device)]
        else:
            x = torch.from_numpy(np.asarray(x, dtype=np.float32)[idx])
        return self.styler._on_device(space.slab(x))

    def _gather(self, x: torch.Tensor, counts) -> torch.Tensor:
        """The frames of all shards, in order, on every shard rank."""
        mesh = self.mesh
        if not mesh.distributed:
            return x
        parts = [torch.empty_like(x) for _ in range(mesh.shape["frames"])]
        dist.all_gather(parts, x.contiguous(), group=mesh.frames_group)
        counts["all_gather"] += 1
        return torch.cat(parts)

    def stylize(self, densities, velocities=None,
                seed: Optional[int] = None, view_schedule=None,
                callback=None):
        """Jointly stylize a (T, *spatial) sequence on the mesh.

        Neither T nor n_views needs to divide the mesh axes: frames are
        padded by replicating the last frame and its velocity (the
        clamp-at-boundary window semantics hold; padded outputs are
        trimmed) and view sets with weight-0 copies of real views (the
        weighted loss is exactly the mean over the real views).

        Args:
          densities: (T, *spatial) array or tensor; every rank passes the
            whole sequence and keeps its own frames.
          velocities: optional (T, *spatial, ndim) sim velocities (the
            window loss, with optim.window > 0).
          seed: the view draws' seed (default ``cfg.seed``); frame t draws
            from its own generator, seeded as the streaming styler seeds
            frame t.
          view_schedule: optional (T, octave_n, iters) pool indices that
            replace the draws (the JAX package's draws, in tests).
          callback: fn(done, loss, octave=o) after every optim.log_every
            iterations, with the last iteration's loss (the mean over all
            frames); called on the ranks that hold a shard.

        Returns:
          (d_star (T, *spatial), params (T, ...), info) on every rank,
          info = {'octave_losses': per-octave (iters,) tensors of the mean
          loss over all (padded) frames}; ``last_collectives`` counts the
          collectives this call issued.
        """
        with span("nfs.job", {"frames": len(densities)}):
            return self._stylize(densities, velocities, seed, view_schedule,
                                 callback)

    def _stylize(self, densities, velocities, seed, view_schedule,
                 callback):
        cfg, styler, mesh = self.cfg, self.styler, self.mesh
        oc = cfg.optim
        seed = cfg.seed if seed is None else seed
        T = int(densities.shape[0])
        spatial = tuple(int(n) for n in densities.shape[1:])
        ndim = len(spatial)
        f_shards, v_shards = mesh.shape["frames"], mesh.shape["views"]
        L = -(-T // f_shards)
        window = oc.window if velocities is not None else 0
        is_vel = oc.parameterization == "velocity"
        param_tail = (ndim,) if is_vel else ()
        counts = _new_counts()
        shapes = octave_shapes(spatial, oc.octave_n, oc.octave_scale)
        losses_by_octave = []
        if mesh.has_shard:
            # the frames' y-slabs (x for 2D; the JAX engine's choice) on
            # the space axis, one slab without one
            space = SpaceSlabs(mesh, spatial, axis=1 if ndim == 3 else 0,
                               halo=halo_rows(cfg, window), lead=1,
                               counts=counts)
            full = space.octave(spatial)    # the states at full resolution
            # this rank's frames; the padding repeats the last frame
            frames = np.arange(mesh.frame_idx * L, (mesh.frame_idx + 1) * L)
            src = np.minimum(frames, T - 1)
            d_full = self._local(densities, src, full)
            vels_full = (self._local(velocities, src, full) if window
                         else None)
            params = torch.zeros(tuple(d_full.shape) + param_tail,
                                 dtype=torch.float32, device=styler.device)
            pool = None
            if ndim == 3:
                n_views = cfg.render.n_views
                nv_pad = -(-n_views // v_shards) * v_shards
                pool = self._view_pool(n_views, nv_pad)
                draws = self._view_draws(frames, pool.shape[0], seed,
                                         view_schedule).to(styler.device)
            else:   # 2D renders the grid itself: no views
                nv_pad = v_shards
                draws = None
            aux = {"vgg": styler.vgg_params, "targets": styler.gram_targets,
                   "content": styler.content_feats}
            prev = spatial      # the octave shape of params
            for o, shape in enumerate(shapes):
                with span("nfs.octave"):
                    shape = tuple(shape)
                    params = space.resize(
                        params, prev, shape,
                        lambda p, _s=shape: resize_frames(p, _s, is_vel))
                    prev = shape
                    d_o = space.resize(
                        d_full, spatial, shape,
                        lambda x, _s=shape: resize_frames(x, _s))
                    vels_o = (space.resize(
                        vels_full, spatial, shape,
                        lambda v, _s=shape: resize_frames(v, _s, True))
                        if window else None)
                    render_size = styler._octave_render_size(shape, spatial)
                    loss = self._loss_frames(
                        ndim, window, render_size,
                        space.octave(shape, warn=True, label=1 + space.axis))
                    opt_state = styler._optimizer.init(params)
                    chunk = oc.log_every if callback is not None else oc.iters
                    done, octave_losses = 0, []
                    while done < oc.iters:
                        n_it = min(chunk, oc.iters - done)
                        step = make_sharded_window_step(
                            mesh, loss, styler._optimizer, window=window,
                            n_views=nv_pad, n_iters=n_it)
                        params, opt_state, losses = step(
                            params, opt_state, d_o, vels_o, pool,
                            None if draws is None else draws[:, o], aux, done)
                        for k, c in step.collectives.items():
                            counts[k] += c
                        octave_losses.append(losses)
                        done += n_it
                        if callback is not None:
                            with span("nfs.readback"):
                                last = float(losses[-1])
                            callback(done, last, octave=o)
                    losses_by_octave.append(torch.cat(octave_losses))
            with torch.no_grad():
                d_star = torch.clamp(
                    self._apply_params(params, d_full, full), min=0.0)
            # the slabs gathered over space, then the frames
            d_star = self._gather(full.whole(d_star), counts)[:T]
            params = self._gather(full.whole(params), counts)[:T]
        else:
            d_star = torch.empty((T,) + spatial, device=styler.device)
            params = torch.empty((T,) + spatial + param_tail,
                                 device=styler.device)
            losses_by_octave = [torch.empty(oc.iters, device=styler.device)
                                for _ in shapes]
        if mesh.distributed and mesh.world > (
                f_shards * v_shards * mesh.size("space")):
            # the ranks past the mesh receive rank 0's result
            flat = torch.cat(losses_by_octave)
            for x in (d_star, params, flat):
                dist.broadcast(x, src=0)
            counts["broadcast"] += 3
            losses_by_octave = list(flat.split(oc.iters))
        self.last_collectives = counts
        return d_star, params, {"octave_losses": losses_by_octave}
