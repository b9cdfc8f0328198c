"""Keyframe-parallel LNST over the ``frames`` axis of a mesh of ranks
(counterpart of ``nfs_tpu/parallel/particles.py``).

:meth:`ParticleStyler.stylize_keyframes` optimizes the keyframes one after
another, each warm-started from the one before. The warm start is a
convergence aid, not the coherence mechanism: coherence comes from
interpolating the optimized attributes along particle identity between
keyframes (LNST §5). Without it the keyframes are independent, and this
engine optimizes them TOGETHER: the keyframes are stacked on a leading
axis and split contiguously over the mesh's ``frames`` axis, and each
rank steps all of its keyframes at once. Every splat is one batched
launch of K4 and every backward one of K5 for all local keyframes, every
render one batched render, and VGG one pass over all their views. The
loss is the sum of the per-keyframe losses, with no cross-keyframe term,
so the step needs no collective. On one GPU (a (1, 1) mesh) it is one
program over all keyframes, which pays the host's launches once for all
of them, not once per keyframe.

SPMD: every rank runs :meth:`ParallelKeyframeStyler.stylize_keyframes`
on the whole sequence, optimizes its own keyframes, and receives every
keyframe's params through one ``all_gather`` on its frames group, so that
every rank yields the whole interpolated sequence, as the JAX call
returns it. Ranks along ``views`` repeat their frame shard's work (the
JAX program splits only ``frames``); ranks past ``frames * views``
receive rank 0's result. A keyframe count that does not divide the
``frames`` axis is padded with replicas of the last keyframe, whose
results are dropped. Keyframe kf draws its views from its own generator,
seeded from (seed, kf), so the result does not depend on the mesh or on
how many keyframes run together.

Each keyframe is binned with the capacity its own ``stylize_frame`` plans
(``ParticleStyler._octave_ks``), laid out at the largest of them
(``bin_particles``' ``capacity``), so it parks the particles its
independent run parks. The JAX engine gives every keyframe the largest
keyframe's K instead: once the K-budget or drift parks particles, a
keyframe's result there depends on the keyframes beside it (ROADMAP
queue 3, F11).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nfs_tpu_torch.ops.resize import octave_shapes
from nfs_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from nfs_tpu_torch.parallel.sharding import _new_counts
from nfs_tpu_torch.styler.particle import (
    ParticleStyler, _octave_max_counts, interp_sequence, keyframe_indices)
from nfs_tpu_torch.utils.profiling import span


def keyframe_generator(seed: int, kf: int) -> torch.Generator:
    """The view-draw generator of keyframe ``kf``: a CPU generator seeded
    from (seed, kf), as the joint grid engine seeds a frame's. Passing it
    to ``ParticleStyler.stylize_frame`` gives the engine's draws."""
    state = np.random.SeedSequence([seed, int(kf)]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


class ParallelKeyframeStyler:
    """Runs a :class:`ParticleStyler`'s keyframe optimization batched over
    the ``frames`` axis of a mesh (LNST data parallelism)."""

    def __init__(self, styler: ParticleStyler, mesh: Optional[Mesh] = None):
        self.styler = styler
        self.cfg = styler.cfg
        if mesh is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            mesh = make_mesh(*mesh_shape_for(world))
        if "frames" not in mesh.shape:
            raise ValueError(
                f"mesh must have a 'frames' axis, got {tuple(mesh.shape)}")
        self.mesh = mesh
        self.last_keyframe_infos = {}
        # collectives issued by the last stylize_keyframes call
        self.last_collectives = _new_counts()

    # ------------------------------------------------------------- #

    def _k_plan(self, x_all: torch.Tensor, shapes, particle_octaves):
        """Every keyframe's bin capacity in every octave from ONE batched
        occupancy probe and one host sync over all keyframes: the plan
        its own ``stylize_frame`` would make (``_octave_ks``, margin 2),
        None where it blows the slot budget; None for the whole plan when
        a particle-path octave of some keyframe cannot run binned (the
        reference's fallback rule)."""
        styler, pc = self.styler, self.cfg.particle
        with span("nfs.bin_plan"):
            with torch.no_grad():
                kmax = _octave_max_counts(
                    x_all, tuple(tuple(s) for s in shapes),
                    float(styler.grid_shape[0]), kernel=pc.kernel)
            with span("nfs.readback"):
                kmax = kmax.cpu().numpy()
            plan = [styler._octave_ks(x, None, shapes, kmaxes=k, margin=2)
                    for x, k in zip(x_all, kmax)]
        if any(ks is None or any(ks[o] is None for o in particle_octaves)
               for ks in plan):
            return None
        return plan

    def _pack(self, param, losses, over):
        """One (L, M) float32 tensor per rank: each keyframe's param
        leaves, per-octave losses and parked counts, flattened."""
        L = over.shape[0]
        parts = [param[k].reshape(L, -1) for k in sorted(param)]
        parts += [torch.stack(losses, dim=1).reshape(L, -1),
                  over.to(torch.float32)]
        return torch.cat(parts, dim=1)

    def _unpack(self, packed, like, n_octaves: int):
        """Inverse of :meth:`_pack` for the gathered (B, M) rows."""
        B, iters = packed.shape[0], self.cfg.optim.iters
        out, i = {}, 0
        for k in sorted(like):
            m = math.prod(like[k].shape[1:])
            out[k] = packed[:, i:i + m].reshape((B,) + like[k].shape[1:])
            i += m
        losses = packed[:, i:i + n_octaves * iters].reshape(
            B, n_octaves, iters)
        over = packed[:, i + n_octaves * iters:].round().long()
        return out, losses, over

    def stylize_keyframes(self, psets, seed: Optional[int] = None,
                          view_schedule=None, callback=None):
        """Optimize every keyframe (stride ``particle.keyframe_stride``,
        plus the last frame) jointly over the mesh, independently of one
        another, then interpolate between them (LNST §5).

        Falls back, with a warning, to the sequential
        ``ParticleStyler.stylize_keyframes`` when some particle-path
        octave cannot run binned (another kernel or support, or an
        occupancy beyond the slot budget), as the JAX engine does.

        Args:
          psets: per-frame ParticleSets with STABLE particle identity;
            every rank passes the whole sequence.
          seed: the view draws' seed (default ``cfg.seed``); keyframe kf
            draws from :func:`keyframe_generator` (seed, kf).
          view_schedule: optional (n_keyframes, octave_n, iters) pool
            indices that replace the draws.
          callback: fn(done, mean_chunk_loss, octave=o), the mean over the
            local keyframes; called on the ranks that hold a shard.

        Yields (frame_index, stylized ParticleSet) for every frame, on
        every rank. ``last_keyframe_infos`` then holds, per keyframe,
        {'octave_losses': per-octave (iters,) tensors, 'octave_overflow':
        parked particles per octave}, and ``last_collectives`` the
        collectives of the call.
        """
        styler, cfg, mesh = self.styler, self.cfg, self.mesh
        oc, pc = cfg.optim, cfg.particle
        seed = cfg.seed if seed is None else seed
        T = len(psets)
        keyframes = keyframe_indices(T, pc.keyframe_stride)
        B = len(keyframes)
        counts = _new_counts()
        self.last_collectives = counts

        xs = [styler._on_device(psets[k].x) for k in keyframes]
        n = xs[0].shape[0]
        if any(x.shape[0] != n for x in xs):
            raise ValueError("keyframe particle counts differ: stable "
                             "particle identity is required (LNST §5)")
        x_all = torch.stack(xs)
        shapes = [tuple(s) for s in octave_shapes(
            styler.grid_shape, oc.octave_n, oc.octave_scale)]
        # grid-space coarse octaves splat the particles once; only the
        # finest octave runs the particle path every iteration
        grid_coarse = (pc.coarse_mode == "grid" and pc.optimize_density
                       and len(shapes) > 1)
        particle_octaves = ([len(shapes) - 1] if grid_coarse
                            else list(range(len(shapes))))
        plan = self._k_plan(x_all, shapes, particle_octaves)
        if plan is None:
            warnings.warn(
                "keyframe-parallel LNST needs the binned splat layout "
                "on every particle-path octave; falling back to the "
                "sequential path", stacklevel=2)
            yield from styler.stylize_keyframes(
                psets, generator=torch.Generator().manual_seed(seed),
                callback=callback, view_schedule=view_schedule)
            self.last_keyframe_infos = styler.last_keyframe_infos
            return

        with span("nfs.job",
                  {"keyframes": f"{keyframes[0]}-{keyframes[-1]}"}):
            shards = mesh.shape["frames"]
            L = -(-B // shards)
            template = styler.init_param(psets[keyframes[0]])
            if mesh.has_shard:
                # this rank's keyframes; the padding repeats the last one
                local = [min(mesh.frame_idx * L + j, B - 1) for j in range(L)]
                packed = self._run_local(psets, keyframes, local, x_all[local],
                                         [plan[i] for i in local], seed,
                                         view_schedule, callback)
                if mesh.distributed:
                    parts = [torch.empty_like(packed) for _ in range(shards)]
                    dist.all_gather(parts, packed.contiguous(),
                                    group=mesh.frames_group)
                    counts["all_gather"] += 1
                    packed = torch.cat(parts)
                packed = packed[:B]
            else:
                m = (sum(math.prod(v.shape) for v in template.values())
                     + len(shapes) * (oc.iters + 1))
                packed = torch.empty((B, m), device=styler.device)
            if mesh.distributed and mesh.world > shards * mesh.shape["views"]:
                # the ranks past the mesh receive rank 0's result
                dist.broadcast(packed, src=0)
                counts["broadcast"] += 1
            params, losses, over = self._unpack(
                packed, {k: v[None] for k, v in template.items()}, len(shapes))

            with span("nfs.readback"):
                over_np = over.cpu().numpy()             # (B, octaves)
            over_thresh = 4 * (int(pc.k_budget * n) if pc.k_budget else 0)
            if over_np.max() > over_thresh:
                warnings.warn(
                    f"binned splat parked up to {int(over_np.max())} overflow "
                    f"particles on some keyframes (per octave max over "
                    f"keyframes: {over_np.max(axis=0).tolist()})",
                    stacklevel=2)
            self.last_keyframe_infos = {
                kf: {"octave_losses": list(losses[i].unbind(0)),
                     "octave_overflow": over_np[i].tolist()}
                for i, kf in enumerate(keyframes)}
        yield from interp_sequence(
            psets, keyframes,
            {kf: {k: v[i] for k, v in params.items()}
             for i, kf in enumerate(keyframes)},
            float(pc.max_offset), apply_fn=styler.apply_param,
            max_log_dens=pc.max_log_dens)

    def _run_local(self, psets, keyframes, local, x, plan, seed,
                   view_schedule, callback) -> torch.Tensor:
        """Optimize the keyframes ``local`` (indices into ``keyframes``;
        ``x`` their (L, N, dim) positions, ``plan`` their bin capacities
        per octave) as one batch; returns their packed results
        (:meth:`_pack`)."""
        styler = self.styler
        sets = [psets[keyframes[i]] for i in local]
        dens = torch.stack([
            styler._on_device(p.dens) if p.dens is not None
            else torch.ones(x.shape[1], dtype=torch.float32,
                            device=styler.device) for p in sets])
        inits = [styler.init_param(p) for p in sets]
        param = {k: torch.stack([p[k] for p in inits]) for k in inits[0]}
        param, losses, overs = styler._optimize_keyframes(
            param, x, dens, plan,
            [keyframe_generator(seed, keyframes[i]) for i in local],
            None if view_schedule is None
            else [np.asarray(view_schedule)[i] for i in local], callback)
        return self._pack(param, losses, overs)
