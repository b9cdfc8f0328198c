"""VGG-19 feature extractor (counterpart of ``nfs_tpu/features/vgg.py``).

``vgg_features(params, images, layers)`` takes NHWC images in [0, 1] and
returns NHWC relu activations, as the JAX function does; inside, the
convolutions run NCHW through ``F.conv2d`` (cuDNN on the GPU, as XLA ran
them in the JAX package). A 3x3 stride-1 ``padding=1`` convolution is
JAX's SAME padding.

Weights: ``params`` maps each conv name to ``{"w": OIHW, "b": (C,)}``
tensors. :func:`params_from_numpy` converts the JAX package's params
(HWIO, nested or the flat ``"{name}/w"`` form ``save_vgg_params`` writes),
and :func:`save_vgg_params` writes that same flat HWIO ``.npz``, so one
file serves both packages. Without a weight file,
:func:`init_vgg_params` draws a He-normal network from a seeded
``torch.Generator``: a valid random-feature style prior, but not the same
numbers as the JAX package's ``jax.random`` init.

``dtype=torch.bfloat16`` casts the normalised input and every weight and
bias to bf16 explicitly (no autocast), as the JAX function casts; the
Gram matrices accumulate in f32 (losses.py).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (name, out_channels); 'pool' entries mark 2x2 stride-2 pooling.
VGG_ARCH: Tuple = (
    ("conv1_1", 64), ("conv1_2", 64), "pool",
    ("conv2_1", 128), ("conv2_2", 128), "pool",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    "pool",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    "pool",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
    "pool",
)

VGG_LAYERS: Tuple[str, ...] = tuple(
    f"relu{e[0][4:]}" for e in VGG_ARCH if isinstance(e, tuple)
)

_CONVS = tuple(e for e in VGG_ARCH if isinstance(e, tuple))
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

Params = Dict[str, Dict[str, torch.Tensor]]


def init_vgg_params(seed: int = 0, device="cpu") -> Params:
    """Deterministic He-normal random VGG-19 (fallback when no weight
    file is given), drawn from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    c_in = 3
    for name, c_out in _CONVS:
        w = torch.randn((c_out, c_in, 3, 3), generator=gen)
        params[name] = {"w": (w * math.sqrt(2.0 / (9 * c_in))).to(device),
                        "b": torch.zeros(c_out, device=device)}
        c_in = c_out
    return params


def params_from_numpy(params: Mapping, device="cpu") -> Params:
    """JAX-package params as numpy -> this package's weights.

    Accepts ``{name: {"w": HWIO, "b": (C,)}}`` or the flat
    ``{"name/w": HWIO, "name/b": (C,)}`` mapping that
    ``nfs_tpu.features.vgg.save_vgg_params`` writes (an open ``.npz``
    works too). Returns ``{name: {"w": OIHW, "b"}}`` float32 tensors."""
    out = {}
    for name, _ in _CONVS:
        if name in params:
            w, b = params[name]["w"], params[name]["b"]
        else:
            w, b = params[f"{name}/w"], params[f"{name}/b"]
        w = np.asarray(w, dtype=np.float32).transpose(3, 2, 0, 1)
        out[name] = {
            "w": torch.from_numpy(np.ascontiguousarray(w)).to(device),
            "b": torch.from_numpy(np.asarray(b, np.float32).copy()).to(device),
        }
    return out


def params_to(params: Params, device) -> Params:
    return {n: {k: v.to(device) for k, v in p.items()}
            for n, p in params.items()}


def load_vgg_params(path: str, device="cpu") -> Params:
    """Load the flat ``'{name}/w'`` (HWIO) + ``'{name}/b'`` .npz."""
    with np.load(path) as raw:
        return params_from_numpy(raw, device=device)


def save_vgg_params(path: str, params: Params) -> None:
    """Write the flat HWIO ``.npz`` that both packages load."""
    flat = {}
    for name, p in params.items():
        w = p["w"].detach().to("cpu", torch.float32).numpy()
        flat[f"{name}/w"] = w.transpose(2, 3, 1, 0)
        flat[f"{name}/b"] = p["b"].detach().to("cpu", torch.float32).numpy()
    np.savez(path, **flat)


def get_vgg_params(path: Optional[str] = None, seed: int = 0,
                   device="cpu") -> Params:
    """File-based loader with deterministic random fallback."""
    if path is not None:
        return load_vgg_params(path, device=device)
    return init_vgg_params(seed=seed, device=device)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (..., H, W, 3) -> ImageNet-normalized."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device)
    std = torch.tensor(_IMAGENET_STD, dtype=images.dtype,
                       device=images.device)
    return (images - mean) / std


def vgg_features(params: Params, images: torch.Tensor,
                 layers: Tuple[str, ...], pool: str = "avg",
                 dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """Run VGG-19 on NHWC ``images`` in [0, 1]; return the requested relu
    activations, NHWC, in the compute dtype. The network runs only as deep
    as the deepest requested layer."""
    want = set(layers)
    unknown = want - set(VGG_LAYERS)
    if unknown:
        raise ValueError(f"unknown VGG layers: {sorted(unknown)}")
    deepest = max(VGG_LAYERS.index(l) for l in layers) if layers else -1

    x = preprocess(images).permute(0, 3, 1, 2)
    if dtype is not None:
        x = x.to(dtype)
    feats: Dict[str, torch.Tensor] = {}
    conv_idx = -1
    for entry in VGG_ARCH:
        if entry == "pool":
            x = (F.avg_pool2d(x, 2) if pool == "avg"
                 else F.max_pool2d(x, 2))
            continue
        conv_idx += 1
        if conv_idx > deepest:
            break
        name, _ = entry
        w = params[name]["w"].to(x.dtype)
        b = params[name]["b"].to(x.dtype)
        x = torch.relu(F.conv2d(x, w, b, padding=1))
        rname = f"relu{name[4:]}"
        if rname in want:
            feats[rname] = x.permute(0, 2, 3, 1)
    return feats
