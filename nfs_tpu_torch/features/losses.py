"""Style-transfer objectives (counterpart of
``nfs_tpu/features/losses.py``; TNST §4).

- Gram style loss (Gatys): per-layer feature Gram matrices matched to the
  style image's, with per-layer weights.
- Semantic loss (DeepDream): maximize the mean activation of one channel.
- Content loss: feature matching against a content image.
- Total-variation regularizer over the optimized field.

Gram matrices accumulate in float32 even when VGG runs in bf16: the
features are cast to f32 before the contraction (a bf16 product is exact
in f32), as ``preferred_element_type=f32`` does in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from nfs_tpu_torch.features.vgg import vgg_features


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) activations -> (..., C, C) Gram matrix
    G = F^T F / (H*W*C), accumulated in f32."""
    h, w, c = feat.shape[-3], feat.shape[-2], feat.shape[-1]
    # (..., C, H*W): a free view for features that vgg_features returns
    # (NHWC views of NCHW tensors)
    f = feat.movedim(-1, -3).reshape(*feat.shape[:-3], c, h * w)
    f = f.to(torch.float32)
    return torch.matmul(f, f.transpose(-1, -2)) / float(h * w * c)


def style_gram_targets(params, style_image: torch.Tensor,
                       layers: Tuple[str, ...], pool: str = "avg",
                       dtype=None) -> Dict[str, torch.Tensor]:
    """The style image's Gram matrices. style_image: (H, W, 3) in [0, 1]."""
    feats = vgg_features(params, style_image[None], layers, pool=pool,
                         dtype=dtype)
    return {l: gram_matrix(f[0]) for l, f in feats.items()}


def style_loss(feats: Dict[str, torch.Tensor],
               target_grams: Dict[str, torch.Tensor],
               layers: Tuple[str, ...],
               layer_weights: Sequence[float]) -> torch.Tensor:
    """Mean over batch images of the weighted per-layer Gram MSE."""
    total = 0.0
    for layer, lw in zip(layers, layer_weights):
        g = gram_matrix(feats[layer])                       # (N, C, C)
        gt = target_grams[layer].to(torch.float32)          # (C, C)
        total = total + lw * torch.mean((g - gt) ** 2)
    return total


def semantic_loss(feats: Dict[str, torch.Tensor], layer: str,
                  channel: Optional[int] = None) -> torch.Tensor:
    """DeepDream objective (to *minimize*): negative mean activation of
    `channel` in `layer` (all channels if channel is None)."""
    f = feats[layer].to(torch.float32)
    if channel is not None:
        f = f[..., channel]
    return -torch.mean(f)


def content_loss(feats: Dict[str, torch.Tensor],
                 target_feats: Dict[str, torch.Tensor],
                 layer: str) -> torch.Tensor:
    f = feats[layer].to(torch.float32)
    t = target_feats[layer].to(torch.float32)
    if t.ndim == f.ndim - 1:  # unbatched target vs batched views
        t = t[None]
    return torch.mean((f - t) ** 2)


def tv_loss(field: torch.Tensor, ndim: Optional[int] = None) -> torch.Tensor:
    """Mean squared forward difference over the leading `ndim` axes."""
    ndim = ndim if ndim is not None else field.ndim
    total = 0.0
    for ax in range(ndim):
        diff = torch.diff(field, dim=ax)
        total = total + torch.mean(diff.to(torch.float32) ** 2)
    return total
