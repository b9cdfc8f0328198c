"""TNST grid stylization engine (counterpart of
``nfs_tpu/styler/grid.py``; TNST arXiv:1905.07442).

Ported: 2D (H, W) and 3D (D, H, W) smoke densities; the density
(``d* = d + dd``) and velocity (``d* = advect(d, v_hat)``, TNST §4.2)
parameterizations; Gram style, semantic and content losses with a TV
regularizer; multi-view rendering from a Poisson-disk view pool for 3D,
the grid itself as the image for 2D (``render2d``); an optional
density -> RGB transfer function, whose control points can be trained
with the field (``render.train_transfer``: the param becomes the dict
``{'field', 'tf'}``); octave Adam; the Gaussian-weighted window-transport
loss and the recursive sequence (TNST §6), whole or block-streamed from a
chunk directory (``io/stream.py``), with the param yielded per frame or
per chunk of frames, and resumed mid-sequence from a saved param; in-frame
checkpoints of {param, Adam state} every ``log_every`` iterations, from
which an interrupted frame resumes mid-octave with the uninterrupted
run's bits (such a frame runs with cuDNN's deterministic convolutions,
which float32 features need on a GPU); a frame split into y-slabs over
the ranks of a space mesh (``parallel/spatial.py``).

The optimization runs eagerly on ``device``. Advection inside the loss
goes through the CUDA kernels K1-K3b (``ops/advect_kernels.py``) on a
GPU.
Random draws come from explicit ``torch.Generator`` objects; since torch
cannot reproduce ``jax.random``, a per-iteration ``view_schedule`` of view
pool indices can be injected to replay the JAX package's draws.
With ``loss.remat_views`` a 3D frame's views are evaluated one at a time
under ``torch.utils.checkpoint``, so the backward holds one view's render
and VGG activations at a time and recomputes them.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from nfs_tpu_torch.core.config import StyleConfig
from nfs_tpu_torch.features.losses import tv_loss
from nfs_tpu_torch.io.checkpoint import (
    load_checkpoint, read_meta, save_checkpoint)
from nfs_tpu_torch.ops.advect import advect, advect_maccormack
from nfs_tpu_torch.ops.jaxgrad import jax_clip
from nfs_tpu_torch.ops.resize import octave_shapes, resize
from nfs_tpu_torch.render.raymarch import (
    render2d, render_views, render_volume)
from nfs_tpu_torch.styler.base import StylerBase
from nfs_tpu_torch.styler.octave import Adam, run_octave


def _one_slab(shape=None):
    """The unsharded frame: a ``parallel.spatial.SpaceSlabs`` of one
    slab, the whole volume, on which every method is the plain
    computation. (Imported here: ``parallel`` imports this module.)"""
    from nfs_tpu_torch.parallel.spatial import SpaceSlabs
    return SpaceSlabs(shape=shape)


@contextlib.contextmanager
def _deterministic_convs():
    """cuDNN's deterministic convolution algorithms for the scope, restored
    after it: at float32 features the default ones differ from run to run
    on a GPU, so a resumed frame would not repeat an uninterrupted one's
    bits. Scoped to a frame, since a process such as the service runs
    other jobs."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = before


class GridStyler(StylerBase):
    """Grid (smoke) stylizer on one torch device.

    Building one turns TF32 off for the process (``styler/base.py``), so
    float32 renders, features and Gram matrices run in full float32 as the
    JAX package computes them; the bfloat16 feature path casts explicitly.
    """

    def __init__(self, cfg: StyleConfig, vgg_params=None,
                 style_image: Optional[np.ndarray] = None,
                 content_image: Optional[np.ndarray] = None,
                 device="cuda"):
        super().__init__(cfg, vgg_params, style_image, content_image,
                         device)
        oc = cfg.optim
        self._loss_cache: Dict[Tuple, object] = {}
        self._optimizer = Adam(oc.lr, b1=oc.b1, b2=oc.b2)
        self._warm_optimizer = (Adam(oc.warm_lr, b1=oc.b1, b2=oc.b2)
                                if oc.warm_lr is not None
                                else self._optimizer)

    # ---------------------------------------------------------------- #
    # loss pipeline: pure functions of (opt_var, views, data)
    # ---------------------------------------------------------------- #

    def _render(self, d_star: torch.Tensor, views: Optional[torch.Tensor],
                render_size=None, tf_nodes=None) -> torch.Tensor:
        """d* -> (V, H, W, 3) images for the CNN: V views of a 3D grid, or
        the 2D grid itself (V = 1, ``views`` unused). ``tf_nodes``
        overrides the styler's transfer function (the trained control
        points of render.train_transfer)."""
        rc = self.cfg.render
        render_size = render_size or rc.render_size
        tf = self.tf_nodes if tf_nodes is None else tf_nodes
        if d_star.ndim == 2:
            return render2d(d_star, out_size=render_size, gamma=rc.gamma,
                            tf_nodes=tf, tf_max=rc.tf_max_density)[None]
        return render_views(d_star, views[:, 0], views[:, 1],
                            transmit=rc.transmit, out_size=render_size,
                            gamma=rc.gamma, method=rc.rotation,
                            tf_nodes=tf, tf_max=rc.tf_max_density)

    def _render_loss(self, d_star, views, render_size, data, tf_nodes=None):
        """Image loss of the views of d_star. With loss.remat_views (3D
        only) each view is rendered and evaluated on its own under
        ``torch.utils.checkpoint``, and the loss is their mean, which
        equals the batched loss (a mean over the batch) up to rounding."""
        if d_star.ndim == 2 or not self.cfg.loss.remat_views:
            return self._image_loss(
                self._render(d_star, views, render_size, tf_nodes), data)
        tf = self.tf_nodes if tf_nodes is None else tf_nodes
        # nothing random is drawn inside a view's loss, so the RNG state
        # (whose capture would synchronize the device) is not preserved
        losses = [checkpoint(self._view_loss, d_star, v, render_size, data,
                             tf, use_reentrant=False,
                             preserve_rng_state=False) for v in views]
        return torch.stack(losses).mean()

    def _view_loss(self, d_star, view, render_size, data, tf):
        rc = self.cfg.render
        img = render_volume(d_star, view[0], view[1], transmit=rc.transmit,
                            out_size=render_size, gamma=rc.gamma,
                            method=rc.rotation, tf_nodes=tf,
                            tf_max=rc.tf_max_density)
        if tf is None:
            img = img[..., None].expand(*img.shape, 3)
        return self._image_loss(img[None], data)

    def _apply_param(self, opt_var, d_base: torch.Tensor,
                     space) -> torch.Tensor:
        """d* of the param on the octave's slabs ``space``
        (``parallel.spatial.SpaceSlabs``), whose advection takes a
        halo."""
        if isinstance(opt_var, dict):  # render.train_transfer
            opt_var = opt_var["field"]
        oc = self.cfg.optim
        if oc.parameterization == "velocity":
            return space.advect(d_base, opt_var, max_disp=oc.param_max_disp,
                                impl=oc.advect_impl)
        return d_base + opt_var

    def _image_loss_weighted(self, imgs: torch.Tensor, pos_weights,
                             data) -> torch.Tensor:
        """Window-batched image loss: imgs (P, V, H, W, 3) holds every
        window position's views, pushed through VGG in one batch. Returns
        sum_p pos_weights[p] * image_loss(imgs[p])."""
        return torch.sum(pos_weights * self._image_losses(imgs, data))

    def _window_weights(self, window: int) -> torch.Tensor:
        oc = self.cfg.optim
        j = torch.arange(-window, window + 1, dtype=torch.float32,
                         device=self.device)
        w = torch.exp(-0.5 * (j / max(oc.window_sigma, 1e-6)) ** 2)
        return w / torch.sum(w)

    def _octave_render_size(self, octave_shape, full_shape):
        """Per-octave render resolution (render.scale_with_octave)."""
        rc = self.cfg.render
        if not rc.scale_with_octave or self.content_feats is not None:
            return rc.render_size
        factor = max(octave_shape[0] / full_shape[0],
                     octave_shape[-1] / full_shape[-1])
        return tuple(
            max(rc.min_render_size, int(round(s * factor / 8)) * 8)
            for s in rc.render_size)

    def _get_loss_fn(self, ndim: int, window: int, render_size=None):
        """Loss closure per structural signature:
        ``loss_fn(opt_var, views, data)`` where ``views`` holds one (V, 2)
        view set per window position (2W+1 of them)."""
        render_size = tuple(render_size or self.cfg.render.render_size)
        sig = (ndim, window, render_size)
        if sig in self._loss_cache:
            return self._loss_cache[sig]
        cfg = self.cfg
        weights = self._window_weights(window) if window else None
        # render.train_transfer: opt_var is {'field', 'tf'}, the control
        # points trained jointly (clipped to [0, 1]) and rendering every
        # window position's state
        train_tf = self._train_tf
        one = _one_slab()

        def loss_fn(opt_var, views, data):
            # the octave's slabs (parallel/spatial.py; one slab without a
            # space mesh): every state is gathered whole where it is
            # rendered or regularized
            space = data.get("space", one)
            whole, run = space.gather, space.advect
            tf = (jax_clip(opt_var["tf"], 0.0, 1.0) if train_tf
                  else None)
            d_star = self._apply_param(opt_var, data["d"], space)
            if window == 0:
                total = self._render_loss(whole(d_star), views[0],
                                          render_size, data, tf)
            else:
                vels = data["vels"]
                md = cfg.optim.max_disp
                impl = cfg.optim.advect_impl
                # all 2W+1 window states (TNST §6): centre, forward
                # transport through the sim velocities, backward inverse
                states = [None] * (2 * window + 1)
                states[window] = d_star
                d_j = d_star
                for j in range(1, window + 1):
                    d_j = run(d_j, vels[window + j - 1], max_disp=md,
                              impl=impl)
                    states[window + j] = d_j
                d_j = d_star
                for j in range(1, window + 1):
                    d_j = run(d_j, -vels[window - j], max_disp=md,
                              impl=impl)
                    states[window - j] = d_j
                states = [whole(s) for s in states]
                if cfg.loss.remat_views and ndim == 3:
                    # one view at a time, position by position
                    total = sum(weights[p] * self._render_loss(
                        s, views[p], render_size, data, tf)
                        for p, s in enumerate(states))
                else:
                    # every position's views through VGG in one batch
                    imgs = torch.stack([
                        self._render(s, views[p], render_size, tf)
                        for p, s in enumerate(states)])
                    total = self._image_loss_weighted(imgs, weights, data)
            if cfg.loss.w_tv:
                field = (opt_var["field"] if isinstance(opt_var, dict)
                         else opt_var)
                total = total + cfg.loss.w_tv * tv_loss(whole(field),
                                                        ndim=ndim)
            return total

        self._loss_cache[sig] = loss_fn
        return loss_fn

    # ---------------------------------------------------------------- #
    # public API
    # ---------------------------------------------------------------- #

    @property
    def _train_tf(self) -> bool:
        return bool(self.cfg.render.train_transfer
                    and self.tf_nodes is not None)

    def _wrap_tf_param(self, param):
        """Lift a tensor param into ``{'field', 'tf'}`` when
        render.train_transfer is on (a copy of the styler's nodes seeds
        'tf'); a dict or a run without it passes through."""
        if self._train_tf and not isinstance(param, dict):
            return {"field": param, "tf": self.tf_nodes.clone()}
        return param

    def _param_on_device(self, param):
        if isinstance(param, dict):
            return {k: self._on_device(v) for k, v in param.items()}
        return self._on_device(param)

    def init_param(self, shape: Tuple[int, ...]) -> torch.Tensor:
        if self.cfg.optim.parameterization == "velocity":
            shape = tuple(shape) + (len(shape),)
        return torch.zeros(tuple(shape), dtype=torch.float32,
                           device=self.device)

    @torch.no_grad()
    def _advect_param(self, param, v: torch.Tensor):
        """Recursive warm-start transport (TNST §6) of the previous
        frame's param through the sim velocity ('semi' or MacCormack).
        Of a ``{'field', 'tf'}`` param only the field lives on the grid;
        the control points carry over unchanged."""
        if isinstance(param, dict):
            return dict(param, field=self._advect_param(param["field"], v))
        oc = self.cfg.optim
        if oc.param_advect == "maccormack":
            return advect_maccormack(param, v, max_disp=oc.max_disp)
        return advect(param, v, max_disp=oc.max_disp)

    def _resize_param(self, param, from_shape: Tuple[int, ...],
                      shape: Tuple[int, ...], space):
        """The param at octave ``from_shape`` resized to octave ``shape``
        on the frame's slabs ``space`` (``parallel.spatial.SpaceSlabs``):
        gathered whole and sliced again as the two octaves are sharded."""
        if isinstance(param, dict):  # only the field has the octave grid
            return dict(param, field=self._resize_param(
                param["field"], from_shape, shape, space))
        is_vel = self.cfg.optim.parameterization == "velocity"
        return space.resize(param, from_shape, shape, lambda p: resize(
            p, shape, is_velocity=is_vel))

    @staticmethod
    def _window_vels(vels: torch.Tensor, t: int, window: int,
                     prev: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(2W, D, H, W, 3) window context of frame t: the velocities of
        frames t-W..t-1, then t..t+W-1, clamped to the sequence. A frame
        before the first is ``prev`` when given (the velocity of the frame
        before a resumed run's first), else the first frame. The JAX
        package always takes the first frame there, so its resume is
        exact only where the two agree (ROADMAP queue 3, F8)."""
        T = vels.shape[0]
        return torch.stack([
            prev if (i < 0 and prev is not None)
            else vels[min(max(i, 0), T - 1)]
            for i in range(t - window, t + window)])

    def _octave_sweep(self, param, d_full, vels_win, generator, warm,
                      schedule=None, callback=None, checkpoint_path=None,
                      space=None):
        """The complete coarse-to-fine optimization of one frame: (param,
        d_star, per-octave (iters,) losses). ``vels_win`` is the (2W,
        *spatial, ndim) window context or None; ``schedule`` optional
        pool indices per octave; ``warm`` picks the optim.warm_iters /
        warm_lr schedule. Every octave starts a fresh Adam, except the
        one a checkpoint at ``checkpoint_path`` resumes. ``space``: the
        frame's slabs on a space mesh (``parallel.spatial.SpaceSlabs``;
        None: one slab, the whole volume); the states are slabs at the
        octaves it shards, whole at the others. A frame with a checkpoint
        runs with deterministic cuDNN convolutions
        (:func:`_deterministic_convs`)."""
        scope = (_deterministic_convs() if checkpoint_path is not None
                 else contextlib.nullcontext())
        with scope:
            return self._sweep(param, d_full, vels_win, generator, warm,
                               schedule, callback, checkpoint_path, space)

    def _sweep(self, param, d_full, vels_win, generator, warm, schedule,
               callback, checkpoint_path, space):
        oc = self.cfg.optim
        if space is None:
            space = _one_slab(d_full.shape)
        full_shape = space.shape
        window = oc.window if vels_win is not None else 0
        iters = self._iters(warm)
        optimizer = self._warm_optimizer if warm else self._optimizer
        shapes = octave_shapes(full_shape, oc.octave_n, oc.octave_scale)
        param = self._wrap_tf_param(param)
        meta = {"log_every": oc.log_every, "iters": iters,
                "shapes": [list(s) for s in shapes]}
        start_octave, start_iter, opt_state = 0, 0, None
        prev = full_shape   # the octave shape of param
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            start_octave, start_iter, param, opt_state = self._resume(
                checkpoint_path, meta, shapes, optimizer)
            prev = shapes[start_octave]
        losses_all = []
        for o, shape in enumerate(shapes):
            # every octave's views are drawn, a resumed run's finished
            # octaves too, so the generator reaches the resumed octave in
            # the uninterrupted run's state
            if len(full_shape) == 2:   # the grid is the image: no views
                views = [[None] * (2 * window + 1)] * iters
            else:
                views = self._octave_views(
                    generator, None if schedule is None else schedule[o],
                    iters, 2 * window + 1)
            if o < start_octave:
                continue
            loss_fn = self._get_loss_fn(
                len(full_shape), window,
                self._octave_render_size(shape, full_shape))
            data = {"pool": self.view_pool, "vgg": self.vgg_params,
                    "targets": self.gram_targets,
                    "content": self.content_feats}
            param = self._resize_param(param, prev, shape, space)
            prev = shape
            data["d"] = space.resize(d_full, full_shape, shape,
                                     lambda d: resize(d, shape))
            data["space"] = space.octave(shape, warn=True)

            def resize_vels(vs, _shape=shape):
                return torch.stack([resize(v, _shape, is_velocity=True)
                                    for v in vs])

            if window:
                data["vels"] = space.resize(vels_win, full_shape, shape,
                                            resize_vels, lead=1)
            cb = state_cb = None
            if callback is not None:
                def cb(done, loss, _o=o):
                    callback(done, loss, octave=_o)
            if checkpoint_path is not None:
                def state_cb(done, p, st, _o=o):
                    save_checkpoint(
                        checkpoint_path, {"param": p, "opt_state": st},
                        meta=dict(meta, octave=_o, iters_done=done))
            resumed = o == start_octave
            param, losses, _ = run_octave(
                param, loss_fn, data, views, iters=iters, lr=oc.lr,
                b1=oc.b1, b2=oc.b2, log_every=oc.log_every, callback=cb,
                optimizer=optimizer,
                init_opt_state=opt_state if resumed else None,
                start_iter=start_iter if resumed else 0,
                state_callback=state_cb)
            losses_all.append(losses)
        param = self._resize_param(param, prev, full_shape, space)
        with torch.no_grad():
            d_star = torch.clamp(self._apply_param(
                param, d_full, space.octave(full_shape)), min=0.0)
        return param, d_star, losses_all

    def _iters(self, warm: bool) -> int:
        oc = self.cfg.optim
        return (oc.warm_iters if (warm and oc.warm_iters is not None)
                else oc.iters)

    def _resume(self, path: str, meta, shapes, optimizer):
        """(octave, iterations done, param, Adam state) of an in-frame
        checkpoint. Resuming reproduces the uninterrupted run only with
        the same log_every (chunk boundaries), iteration budget and octave
        ladder, so a checkpoint written with others is refused."""
        got = read_meta(path) or {}
        for k, want in meta.items():
            have = got.get(k, want)
            if have != want:
                raise ValueError(
                    f"in-frame checkpoint {path} was written with "
                    f"{k}={have} but this run uses {k}={want}; resuming "
                    f"would not bit-match an uninterrupted run. Restore "
                    f"the original flag or delete the checkpoint to "
                    f"restart the frame.")
        o = int(got["octave"])
        like = self._wrap_tf_param(self.init_param(shapes[o]))
        state, _ = load_checkpoint(
            path, {"param": like, "opt_state": optimizer.init(like)})
        return o, int(got["iters_done"]), state["param"], state["opt_state"]

    def stylize_frame(self, d: np.ndarray,
                      vels: Optional[np.ndarray] = None,
                      init_param: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      callback=None,
                      checkpoint_path: Optional[str] = None,
                      warm: Optional[bool] = None,
                      view_schedule=None, space=None):
        """Stylize one frame (or one temporal window around a frame).

        Args:
          d: (H, W) or (D, H, W) density of the centre frame.
          vels: optional (2W, *spatial, ndim) sim velocities for the
            window loss: vels[:W] are frames t-W..t-1 (backward transport
            uses their negation), vels[W:] are frames t..t+W-1 (forward).
          init_param: warm-start variable at full resolution (a tensor,
            or a ``{'field', 'tf'}`` dict with render.train_transfer).
          generator: CPU ``torch.Generator`` for the view draws; default
            seeded with ``cfg.seed``.
          callback: fn(done, mean_chunk_loss, octave=o) every log_every
            iterations, called after the chunk's checkpoint is written.
          checkpoint_path: if set, {param, Adam state} is written there
            after every log_every-iteration chunk, and a call finding a
            checkpoint there resumes from it (its octave, its iterations
            done) with the uninterrupted run's bits. A checkpoint written
            with another log_every, iteration budget or octave ladder is
            refused with ValueError. The file is removed when the frame
            completes.
          warm: use the optim.warm_iters/warm_lr schedule; None = warm iff
            init_param is given.
          view_schedule: optional pool indices, (octave_n, iters) or
            (octave_n, iters, 2W+1), replacing the generator's draws.
          space: the frame's slabs on a space mesh
            (``parallel.spatial.SpaceSlabs``); ``d``, ``vels`` and
            ``init_param`` are then this rank's slabs (whole where the
            finest octave runs replicated), and so are d_star and param.
            ``parallel.spatial.stylize_frame_spatial`` sets it up.

        Returns:
          (d_star, param, info): stylized full-res density, final
          variable, {'octave_losses': [per-octave (iters,) tensors of the
          iterations run in this call]}, plus 'tf_nodes' (the trained
          control points, clipped to [0, 1]) with render.train_transfer.
        """
        cfg = self.cfg
        warm = (init_param is not None) if warm is None else warm
        d_full = self._on_device(d)
        full_shape = tuple(d_full.shape)
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(cfg.seed))
        window = cfg.optim.window if vels is not None else 0
        param = (self._param_on_device(init_param)
                 if init_param is not None else self.init_param(full_shape))
        param, d_star, losses = self._octave_sweep(
            param, d_full, self._on_device(vels) if window else None,
            generator, warm, view_schedule, callback, checkpoint_path,
            space)
        if checkpoint_path is not None and os.path.exists(checkpoint_path):
            os.unlink(checkpoint_path)
        info = {"octave_losses": losses}
        if self._train_tf:
            with torch.no_grad():
                info["tf_nodes"] = torch.clamp(param["tf"], 0.0, 1.0)
        return d_star, param, info

    def _frame_generator(self, t: int) -> torch.Generator:
        """Per-frame generator, seeded by the frame's absolute index in the
        sequence (or the same seed for every frame with
        render.fixed_view_schedule). Every sequence path keys its frames
        the same way, so a resumed run draws what the uninterrupted run
        drew."""
        if self.cfg.render.fixed_view_schedule:
            return torch.Generator().manual_seed(self.cfg.seed)
        seed = np.random.SeedSequence([self.cfg.seed, t])
        return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))

    def stylize_sequence(self, densities, velocities=None, callback=None,
                         fused: Optional[int] = None,
                         checkpoint_path: Optional[str] = None,
                         view_schedule=None,
                         init_param: Optional[torch.Tensor] = None,
                         prev_velocity=None, frame_offset: int = 0):
        """Stylize a frame sequence with temporal coherence (TNST §6):
        each frame is warm-started by transporting the previous frame's
        param forward.

        Args:
          densities: (T, D, H, W) array or list of per-frame densities.
          velocities: optional (T, D, H, W, 3) sim velocities (cells per
            frame); needed for the window loss and the recursive init.
          fused: frames per chunk. None reads ``optim.fused_frames``. 0 or
            1 yields param with every frame; F > 1 yields it only at the
            end of each chunk of F frames and at the last frame, as the
            JAX package's fused path does (a fresh run's frame 0 stands
            before the first chunk when optim.warm_iters or warm_lr is
            set). Only the yields differ: eager torch has no dispatch to
            fuse, so the frames are stylized alike either way, with the
            same per-frame generators. The JAX package's chunk
            executables, carry masks and padded tail chunks (which avoid
            recompiles on the TPU) have no counterpart, and where its
            fused path draws from another PRNG stream than its streaming
            path, the port's two agree.
          checkpoint_path: in-frame checkpoints of every frame, as
            :meth:`stylize_frame` takes them; param is then yielded with
            every frame, whatever ``fused`` says, so a rerun that
            continues the chain at the interrupted frame (``init_param``
            and ``frame_offset`` below) resumes that frame mid-octave.
          view_schedule: optional per-frame pool indices, (T, octave_n,
            iters[, 2W+1]).
          init_param / prev_velocity / frame_offset: continue the
            recursive warm-start chain mid-sequence. ``init_param`` is the
            previous (completed) frame's final param, ``prev_velocity``
            that frame's sim velocity (it transports init_param into
            frame 0 and is frame 0's backward window tap),
            ``frame_offset`` the absolute index of densities[0]. Frame
            generators are keyed on ``frame_offset + t``, so with W <= 1
            a resumed run computes what the uninterrupted run did.

        Yields (frame_index, d_star, param) per frame (param None between
        chunk ends); the per-iteration losses of every frame are in
        :attr:`frame_losses`, (octave_n, iters); a frame resumed from an
        in-frame checkpoint has NaN for the iterations run before the
        interruption.
        """
        oc = self.cfg.optim
        fused = oc.fused_frames if fused is None else fused
        # one bulk upload of the whole sequence
        densities = self._on_device(densities)
        if velocities is not None:
            velocities = self._on_device(velocities)
        if prev_velocity is not None:
            prev_velocity = self._on_device(prev_velocity)
        if init_param is not None:
            init_param = self._param_on_device(init_param)
        T = densities.shape[0]
        # a fresh run's cold frame 0 precedes the chunks of warm frames
        chunk0 = int(init_param is None and (oc.warm_iters is not None
                                             or oc.warm_lr is not None))
        self.frame_losses: Dict[int, torch.Tensor] = {}
        for t, d_star, param, losses in self._frames(
                densities, velocities, 0, init_param, prev_velocity,
                frame_offset, view_schedule, callback, checkpoint_path):
            self.frame_losses[t] = losses
            # with in-frame checkpoints every frame is a chunk end, as the
            # JAX package drops to streaming for them: a rerun continues
            # at the interrupted frame, whose checkpoint it finds
            chunk_end = (checkpoint_path is not None or fused <= 1
                         or t == T - 1
                         or (t >= chunk0 and (t + 1 - chunk0) % fused == 0))
            yield t, d_star, (param if chunk_end else None)

    def _frames(self, densities, vels, offset: int, param, prev_velocity,
                frame_offset: int, view_schedule=None, callback=None,
                checkpoint_path=None):
        """The frame loop of every sequence path: yields (t, d_star,
        param, (octave_n, iters) losses, NaN where a resumed frame skipped
        iterations) for each frame t of
        ``densities``. ``vels`` (or None) holds the sim velocities from
        frame ``-offset`` on, counted from densities[0]; ``param``, when
        given, is the previous frame's final param, transported into
        frame 0 by ``prev_velocity``."""
        W = self.cfg.optim.window
        for t in range(densities.shape[0]):
            vels_win = None
            if W > 0 and vels is not None:
                vels_win = self._window_vels(vels, offset + t, W,
                                             prev_velocity)
            if param is not None:
                v_prev = prev_velocity
                if t > 0:
                    v_prev = None if vels is None else vels[offset + t - 1]
                if v_prev is not None:
                    param = self._advect_param(param, v_prev)
            warm = param is not None
            d_star, param, info = self.stylize_frame(
                densities[t], vels=vels_win, init_param=param,
                generator=self._frame_generator(frame_offset + t),
                callback=callback, checkpoint_path=checkpoint_path,
                view_schedule=(None if view_schedule is None
                               else view_schedule[t]))
            ran = torch.cat(info["octave_losses"])
            table = ran.new_full(
                (self.cfg.optim.octave_n * self._iters(warm),), float("nan"))
            table[table.numel() - ran.numel():] = ran
            yield t, d_star, param, table.view(self.cfg.optim.octave_n, -1)

    def stylize_sequence_blocks(self, blocks, fused: int = 8,
                                view_schedule=None):
        """Block-streamed sequence: frames arrive in host-memory blocks
        (``io/stream.py`` ``iter_sequence_blocks`` reads them from a
        chunk directory), so the device holds one block and its working
        set. Each block runs through the frame loop of
        :meth:`stylize_sequence`, continuing the previous block's carry;
        frame generators are keyed on the absolute frame index, so the
        frames equal the streaming path's.

        Args:
          blocks: iterable of (t0, dens_block (B, D, H, W), vels_ctx),
            vels_ctx None (no temporal coupling) or a (B + 2P, D, H, W, 3)
            velocity context covering global frames [t0 - P, t0 + B + P)
            with P = max(window, 1), edge frames replicated at the true
            sequence boundaries. The carry enters a block through
            vels_ctx[P - 1].
          fused: the JAX package's frames per dispatch within a block.
            Both packages yield param only at block ends, and eager torch
            has no dispatch to fuse, so it changes nothing here.
          view_schedule: optional pool indices per absolute frame,
            (T, octave_n, iters[, 2W+1]).

        Yields (t, d_star, param): param is the carry after each block's
        last frame (None mid-block), usable for restarts. Per-iteration
        losses land in :attr:`frame_losses`, keyed on t.
        """
        P = max(self.cfg.optim.window, 1)
        self.frame_losses = {}
        carry = None
        for t0, dens_block, vels_ctx in blocks:
            dens_block = self._on_device(dens_block)
            B = dens_block.shape[0]
            prev = None
            if vels_ctx is not None:
                vels_ctx = self._on_device(vels_ctx)
                prev = vels_ctx[P - 1]
            if carry is None and t0 > 0:
                # a stream that starts mid-sequence warm-starts from zeros
                carry = self.init_param(tuple(dens_block.shape[1:]))
            for t, d_star, carry, losses in self._frames(
                    dens_block, vels_ctx, P, carry, prev, t0,
                    None if view_schedule is None
                    else view_schedule[t0:t0 + B]):
                self.frame_losses[t0 + t] = losses
                yield t0 + t, d_star, (carry if t == B - 1 else None)
