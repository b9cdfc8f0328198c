"""TNST grid stylization engine (counterpart of
``nfs_tpu/styler/grid.py``; TNST arXiv:1905.07442).

Ported: 3D (D, H, W) smoke densities; the density (``d* = d + dd``) and
velocity (``d* = advect(d, v_hat)``, TNST §4.2) parameterizations; Gram
style, semantic and content losses with a TV regularizer; multi-view
rendering from a Poisson-disk view pool; octave Adam; the
Gaussian-weighted window-transport loss and the streaming recursive
sequence path (TNST §6).

The optimization runs eagerly on ``device``. Advection inside the loss
goes through the CUDA kernels K1-K3 (``ops/advect_kernels.py``) on a GPU.
Random draws come from explicit ``torch.Generator`` objects; since torch
cannot reproduce ``jax.random``, a per-iteration ``view_schedule`` of view
pool indices can be injected to replay the JAX package's draws.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): 2D grids, fused multi-frame and block-streamed sequences,
per-view rematerialization, transfer functions, in-frame checkpoints.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nfs_tpu_torch.core.config import StyleConfig
from nfs_tpu_torch.features.losses import (
    content_loss, gram_matrix, semantic_loss, style_gram_targets,
    style_loss, tv_loss)
from nfs_tpu_torch.features.vgg import (
    get_vgg_params, params_to, vgg_features)
from nfs_tpu_torch.io.image import load_image
from nfs_tpu_torch.ops.advect import advect, advect_maccormack
from nfs_tpu_torch.ops.resize import octave_shapes, resize
from nfs_tpu_torch.render.camera import (
    poisson_view_pool, sample_views_stratified)
from nfs_tpu_torch.render.raymarch import render_views
from nfs_tpu_torch.styler.octave import Adam, run_octave


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to nfs_tpu_torch yet: ROADMAP queue 1, "
        f"{item}")


class GridStyler:
    """Grid (smoke) stylizer on one torch device.

    Building one sets ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` to False for the process,
    so float32 renders, features and Gram matrices run in full float32 as
    the JAX package computes them; the bfloat16 feature path casts
    explicitly.
    """

    def __init__(self, cfg: StyleConfig, vgg_params=None,
                 style_image: Optional[np.ndarray] = None,
                 content_image: Optional[np.ndarray] = None,
                 device="cuda"):
        rc, lc, oc = cfg.render, cfg.loss, cfg.optim
        if rc.transfer_fn or rc.train_transfer:
            raise _not_ported("render.transfer_fn / train_transfer",
                              "item 15")
        if lc.remat_views:
            raise _not_ported("loss.remat_views", "item 10")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.device = torch.device(device)
        dev = self.device
        params = (vgg_params if vgg_params is not None else
                  get_vgg_params(lc.vgg_weights, seed=cfg.seed))
        self.vgg_params = params_to(params, dev)

        if style_image is None and lc.style_target:
            style_image = load_image(lc.style_target, size=rc.render_size)
        self.gram_targets = None
        if style_image is not None:
            with torch.no_grad():
                self.gram_targets = style_gram_targets(
                    self.vgg_params,
                    torch.as_tensor(style_image, dtype=torch.float32,
                                    device=dev),
                    lc.style_layers, pool=lc.pool)

        if content_image is None and lc.content_target:
            content_image = load_image(lc.content_target,
                                       size=rc.render_size)
        self.content_feats = None
        if content_image is not None and lc.content_layer:
            with torch.no_grad():
                self.content_feats = vgg_features(
                    self.vgg_params,
                    torch.as_tensor(content_image, dtype=torch.float32,
                                    device=dev)[None],
                    (lc.content_layer,), pool=lc.pool)

        # Poisson-disk view pool (numpy, the JAX package's pool for the
        # same seed), shipped to the device once
        self.view_pool = None
        if rc.sample_type == "poisson":
            self.view_pool = torch.from_numpy(poisson_view_pool(
                rc.view_pool, rc.n_views, (rc.theta0, rc.theta1),
                (rc.phi0, rc.phi1), seed=cfg.seed)).to(dev)

        self._loss_cache: Dict[Tuple, object] = {}
        self._optimizer = Adam(oc.lr, b1=oc.b1, b2=oc.b2)
        self._warm_optimizer = (Adam(oc.warm_lr, b1=oc.b1, b2=oc.b2)
                                if oc.warm_lr is not None
                                else self._optimizer)

    # ---------------------------------------------------------------- #
    # loss pipeline: pure functions of (opt_var, views, data)
    # ---------------------------------------------------------------- #

    def _sample_views(self, generator: torch.Generator,
                      pool: Optional[torch.Tensor]) -> torch.Tensor:
        """One (V, 2) view set: a pool entry drawn with ``generator``, or
        a stratified sample without a pool."""
        rc = self.cfg.render
        if pool is not None:
            idx = int(torch.randint(pool.shape[0], (), generator=generator))
            return pool[idx]
        return sample_views_stratified(
            generator, rc.n_views, (rc.theta0, rc.theta1),
            (rc.phi0, rc.phi1), device=self.device)

    def _render(self, d_star: torch.Tensor, views: torch.Tensor,
                render_size=None) -> torch.Tensor:
        """d* -> (V, H, W, 3) images for the CNN."""
        rc = self.cfg.render
        if d_star.ndim == 2:
            raise _not_ported("2D grids (render2d)", "item 6")
        return render_views(d_star, views[:, 0], views[:, 1],
                            transmit=rc.transmit,
                            out_size=render_size or rc.render_size,
                            gamma=rc.gamma, method=rc.rotation)

    def _render_loss(self, d_star, views, render_size, data):
        return self._image_loss(self._render(d_star, views, render_size),
                                data)

    def _apply_param(self, opt_var: torch.Tensor,
                     d_base: torch.Tensor) -> torch.Tensor:
        oc = self.cfg.optim
        if oc.parameterization == "velocity":
            return advect(d_base, opt_var, max_disp=oc.param_max_disp,
                          impl=oc.advect_impl)
        return d_base + opt_var

    def _features(self, imgs, data):
        lc = self.cfg.loss
        layers = set()
        if data["targets"] is not None:
            layers |= set(lc.style_layers)
        if lc.content_layer:
            layers.add(lc.content_layer)
        dtype = torch.bfloat16 if lc.features_dtype == "bfloat16" else None
        return vgg_features(data["vgg"], imgs, tuple(sorted(layers)),
                            pool=lc.pool, dtype=dtype)

    def _image_loss_weighted(self, imgs: torch.Tensor, pos_weights,
                             data) -> torch.Tensor:
        """Window-batched image loss: imgs (P, V, H, W, 3) holds every
        window position's views, pushed through VGG in one batch. Returns
        sum_p pos_weights[p] * image_loss(imgs[p])."""
        lc = self.cfg.loss
        P, V = imgs.shape[0], imgs.shape[1]
        feats = self._features(imgs.reshape((P * V,) + imgs.shape[2:]),
                               data)
        total = torch.zeros((), dtype=torch.float32, device=imgs.device)
        if data["targets"] is not None and lc.w_style:
            for layer, lw in zip(lc.style_layers, lc.style_layer_weights):
                g = gram_matrix(feats[layer])                 # (P*V,C,C)
                gt = data["targets"][layer].to(torch.float32)
                mse = torch.mean((g - gt) ** 2, dim=(-2, -1))
                per_pos = torch.mean(mse.reshape(P, V), dim=1)
                total = total + lc.w_style * lw * torch.sum(
                    pos_weights * per_pos)
        if lc.content_layer and lc.w_content:
            f = feats[lc.content_layer].to(torch.float32)
            dims = tuple(range(1, f.ndim))
            if data["content"] is not None:
                ft = data["content"][lc.content_layer].to(torch.float32)
                mse = torch.mean((f - ft) ** 2, dim=dims)
            else:
                ch = (f if lc.content_channel is None
                      else f[..., lc.content_channel])
                mse = -torch.mean(ch, dim=tuple(range(1, ch.ndim)))
            per_pos = torch.mean(mse.reshape(P, V), dim=1)
            total = total + lc.w_content * torch.sum(pos_weights * per_pos)
        return total

    def _image_loss(self, imgs: torch.Tensor, data) -> torch.Tensor:
        lc = self.cfg.loss
        feats = self._features(imgs, data)
        total = torch.zeros((), dtype=torch.float32, device=imgs.device)
        if data["targets"] is not None and lc.w_style:
            total = total + lc.w_style * style_loss(
                feats, data["targets"], lc.style_layers,
                lc.style_layer_weights)
        if lc.content_layer and lc.w_content:
            if data["content"] is not None:
                total = total + lc.w_content * content_loss(
                    feats, data["content"], lc.content_layer)
            else:
                total = total + lc.w_content * semantic_loss(
                    feats, lc.content_layer, lc.content_channel)
        return total

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

        def loss_fn(opt_var, views, data):
            d_star = self._apply_param(opt_var, data["d"])
            if window == 0:
                total = self._render_loss(d_star, views[0], render_size,
                                          data)
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
                    d_j = advect(d_j, vels[window + j - 1], max_disp=md,
                                 impl=impl)
                    states[window + j] = d_j
                d_j = d_star
                for j in range(1, window + 1):
                    d_j = advect(d_j, -vels[window - j], max_disp=md,
                                 impl=impl)
                    states[window - j] = d_j
                imgs = torch.stack([
                    self._render(s, views[p], render_size)
                    for p, s in enumerate(states)])
                total = self._image_loss_weighted(imgs, weights, data)
            if cfg.loss.w_tv:
                total = total + cfg.loss.w_tv * tv_loss(opt_var, ndim=ndim)
            return total

        self._loss_cache[sig] = loss_fn
        return loss_fn

    # ---------------------------------------------------------------- #
    # public API
    # ---------------------------------------------------------------- #

    def init_param(self, shape: Tuple[int, ...]) -> torch.Tensor:
        if self.cfg.optim.parameterization == "velocity":
            shape = tuple(shape) + (len(shape),)
        return torch.zeros(tuple(shape), dtype=torch.float32,
                           device=self.device)

    @torch.no_grad()
    def _advect_param(self, param: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
        """Recursive warm-start transport (TNST §6) of the previous
        frame's param through the sim velocity ('semi' or MacCormack)."""
        oc = self.cfg.optim
        if oc.param_advect == "maccormack":
            return advect_maccormack(param, v, max_disp=oc.max_disp)
        return advect(param, v, max_disp=oc.max_disp)

    def _resize_param(self, param, shape: Tuple[int, ...]):
        if tuple(param.shape[:len(shape)]) == tuple(shape):
            return param
        is_vel = self.cfg.optim.parameterization == "velocity"
        return resize(param, shape, is_velocity=is_vel)

    def _octave_views(self, generator, schedule, iters: int, positions: int):
        """Per-iteration view arguments of one octave: ``positions`` view
        sets per iteration, from ``schedule`` (pool indices, (iters,) or
        (iters, positions)) or drawn from ``generator``."""
        pool = self.view_pool
        if schedule is None:
            return [[self._sample_views(generator, pool)
                     for _ in range(positions)] for _ in range(iters)]
        if pool is None:
            raise ValueError("view_schedule needs render.sample_type "
                             "'poisson' (a view pool)")
        sched = np.asarray(schedule, dtype=np.int64).reshape(iters, -1)
        sched = np.broadcast_to(sched, (iters, positions))
        return [[pool[int(j)] for j in row] for row in sched]

    def stylize_frame(self, d: np.ndarray,
                      vels: Optional[np.ndarray] = None,
                      init_param: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      callback=None,
                      checkpoint_path: Optional[str] = None,
                      warm: Optional[bool] = None,
                      view_schedule=None):
        """Stylize one frame (or one temporal window around a frame).

        Args:
          d: (D, H, W) density of the centre frame.
          vels: optional (2W, D, H, W, 3) sim velocities for the window
            loss: vels[:W] are frames t-W..t-1 (backward transport uses
            their negation), vels[W:] are frames t..t+W-1 (forward).
          init_param: warm-start variable at full resolution.
          generator: CPU ``torch.Generator`` for the view draws; default
            seeded with ``cfg.seed``.
          callback: fn(done, mean_chunk_loss, octave=o) every log_every
            iterations.
          warm: use the optim.warm_iters/warm_lr schedule; None = warm iff
            init_param is given.
          view_schedule: optional pool indices, (octave_n, iters) or
            (octave_n, iters, 2W+1), replacing the generator's draws.

        Returns:
          (d_star, param, info): stylized full-res density, final
          variable, {'octave_losses': [per-octave (iters,) tensors]}.
        """
        if checkpoint_path is not None:
            raise _not_ported("in-frame checkpoints (checkpoint_path)",
                              "item 16")
        cfg = self.cfg
        oc = cfg.optim
        warm = (init_param is not None) if warm is None else warm
        iters = (oc.warm_iters if (warm and oc.warm_iters is not None)
                 else oc.iters)
        optimizer = self._warm_optimizer if warm else self._optimizer
        d_full = self._on_device(d)
        full_shape = tuple(d_full.shape)
        generator = (generator if generator is not None
                     else torch.Generator().manual_seed(cfg.seed))
        window = oc.window if vels is not None else 0
        shapes = octave_shapes(full_shape, oc.octave_n, oc.octave_scale)
        param = (self._on_device(init_param) if init_param is not None
                 else self.init_param(full_shape))
        vels_full = self._on_device(vels) if window else None
        info = {"octave_losses": []}

        for o, shape in enumerate(shapes):
            param = self._resize_param(param, shape)
            d_o = resize(d_full, shape) if shape != full_shape else d_full
            data = {"d": d_o, "pool": self.view_pool,
                    "vgg": self.vgg_params, "targets": self.gram_targets,
                    "content": self.content_feats}
            if window:
                data["vels"] = (vels_full if shape == full_shape else
                                torch.stack([resize(v, shape,
                                                    is_velocity=True)
                                             for v in vels_full]))
            loss_fn = self._get_loss_fn(
                d_full.ndim, window,
                self._octave_render_size(shape, full_shape))
            views = self._octave_views(
                generator,
                None if view_schedule is None else view_schedule[o],
                iters, 2 * window + 1)
            cb = None
            if callback is not None:
                def cb(done, loss, _o=o):
                    callback(done, loss, octave=_o)
            param, losses, _ = run_octave(
                param, loss_fn, data, views, iters=iters, lr=oc.lr,
                b1=oc.b1, b2=oc.b2, log_every=oc.log_every, callback=cb,
                optimizer=optimizer)
            info["octave_losses"].append(losses)

        with torch.no_grad():
            d_star = torch.clamp(self._apply_param(param, d_full), min=0.0)
        return d_star, param, info

    def _on_device(self, x) -> torch.Tensor:
        """float32 tensor on the styler's device from an array, a list of
        arrays or a tensor."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _frame_generator(self, t: int) -> torch.Generator:
        """Per-frame generator, seeded by the frame's index in the
        sequence (or the same seed for every frame with
        render.fixed_view_schedule)."""
        if self.cfg.render.fixed_view_schedule:
            return torch.Generator().manual_seed(self.cfg.seed)
        seed = np.random.SeedSequence([self.cfg.seed, t])
        return torch.Generator().manual_seed(int(seed.generate_state(1)[0]))

    def stylize_sequence(self, densities, velocities=None, callback=None,
                         fused: Optional[int] = None,
                         checkpoint_path: Optional[str] = None,
                         view_schedule=None):
        """Stylize a frame sequence with temporal coherence (TNST §6), on
        the streaming path: one frame after the other, each warm-started
        by transporting the previous frame's param forward.

        Args:
          densities: (T, D, H, W) array or list of per-frame densities.
          velocities: optional (T, D, H, W, 3) sim velocities (cells per
            frame); needed for the window loss and the recursive init.
          fused: frames per dispatch; only 0/1 (streaming) is ported.
          view_schedule: optional per-frame pool indices, (T, octave_n,
            iters[, 2W+1]).

        Yields (frame_index, d_star, param) per frame.
        """
        cfg = self.cfg
        fused = cfg.optim.fused_frames if fused is None else fused
        if fused and fused > 1:
            raise _not_ported("fused multi-frame sequences (fused > 1)",
                              "item 13")
        if checkpoint_path is not None:
            raise _not_ported("in-frame checkpoints (checkpoint_path)",
                              "item 16")
        W = cfg.optim.window
        # one bulk upload of the whole sequence
        densities = self._on_device(densities)
        if velocities is not None:
            velocities = self._on_device(velocities)
        T = densities.shape[0]
        param = None
        for t in range(T):
            vels_win = None
            if W > 0 and velocities is not None:
                idx = ([max(t - W + j, 0) for j in range(W)]
                       + [min(t + j, T - 1) for j in range(W)])
                vels_win = velocities[idx]
            if param is not None and velocities is not None:
                param = self._advect_param(param, velocities[t - 1])
            d_star, param, _ = self.stylize_frame(
                densities[t], vels=vels_win, init_param=param,
                generator=self._frame_generator(t),
                callback=callback,
                view_schedule=(None if view_schedule is None
                               else view_schedule[t]))
            yield t, d_star, param

    def stylize_sequence_blocks(self, *args, **kwargs):
        raise _not_ported("block-streamed sequences", "item 13")
