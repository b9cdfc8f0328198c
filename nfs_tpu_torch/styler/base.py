"""What the grid and particle stylers share: the loss network and its
targets on one torch device, the view pool and per-iteration view draws,
and the Gram / semantic / content image loss.

Building a styler sets ``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False for the process, so
float32 renders, features and Gram matrices run in full float32 as the
JAX package computes them; the bfloat16 feature path casts explicitly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nfs_tpu_torch.core.config import StyleConfig
from nfs_tpu_torch.features.losses import gram_matrix, style_gram_targets
from nfs_tpu_torch.features.vgg import (
    get_vgg_params, params_to, vgg_features)
from nfs_tpu_torch.io.image import load_image
from nfs_tpu_torch.render.camera import (
    poisson_view_pool, sample_views_stratified)
from nfs_tpu_torch.render.transfer import resolve_transfer
from nfs_tpu_torch.utils.profiling import span


class StylerBase:
    """Loss network, style/content targets, view pool and transfer
    function on ``device``."""

    def __init__(self, cfg: StyleConfig, vgg_params=None,
                 style_image: Optional[np.ndarray] = None,
                 content_image: Optional[np.ndarray] = None,
                 device="cuda"):
        rc, lc = cfg.render, cfg.loss
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

        # optional density -> RGB transfer function (render/transfer.py),
        # resolved once
        self.tf_nodes = None
        if rc.transfer_fn:
            self.tf_nodes = torch.as_tensor(
                resolve_transfer(rc.transfer_fn), dtype=torch.float32,
                device=dev)

        # Poisson-disk view pool (numpy, the JAX package's pool for the
        # same seed), shipped to the device once
        self.view_pool = None
        if rc.sample_type == "poisson":
            self.view_pool = torch.from_numpy(poisson_view_pool(
                rc.view_pool, rc.n_views, (rc.theta0, rc.theta1),
                (rc.phi0, rc.phi1), seed=cfg.seed)).to(dev)

    def _on_device(self, x) -> torch.Tensor:
        """float32 tensor on the styler's device from an array, a list of
        arrays or a tensor."""
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x, dtype=np.float32)
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------------- #
    # view draws
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

    # ---------------------------------------------------------------- #
    # image loss
    # ---------------------------------------------------------------- #

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

    def _image_loss(self, imgs: torch.Tensor, data) -> torch.Tensor:
        """The image loss of one (V, H, W, 3) view set."""
        return self._image_losses(imgs[None], data)[0]

    def _image_losses(self, imgs: torch.Tensor, data) -> torch.Tensor:
        """The image loss of each of B view sets, imgs (B, V, H, W, 3),
        pushed through VGG in one batch: (B,) losses, each the weighted
        Gram MSE over the style layers plus the content (or semantic)
        term, every one a mean over its set's V images."""
        with span("nfs.features"):
            lc = self.cfg.loss
            B = imgs.shape[0]
            feats = self._features(imgs.reshape((-1,) + imgs.shape[2:]),
                                   data)
            total = torch.zeros(B, dtype=torch.float32, device=imgs.device)

            def per_set(x):
                return torch.mean(x.reshape(B, -1), dim=1)

            if data["targets"] is not None and lc.w_style:
                style = 0.0
                for layer, lw in zip(lc.style_layers,
                                     lc.style_layer_weights):
                    g = gram_matrix(feats[layer])
                    gt = data["targets"][layer].to(torch.float32)
                    style = style + lw * per_set((g - gt) ** 2)
                total = total + lc.w_style * style
            if lc.content_layer and lc.w_content:
                f = feats[lc.content_layer].to(torch.float32)
                if data["content"] is not None:
                    t = data["content"][lc.content_layer].to(torch.float32)
                    total = total + lc.w_content * per_set((f - t) ** 2)
                else:
                    ch = (f if lc.content_channel is None
                          else f[..., lc.content_channel])
                    total = total - lc.w_content * per_set(ch)
            return total
