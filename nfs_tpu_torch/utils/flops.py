"""Analytic FLOP count and MFU (model FLOP utilization) of the
stylization step (counterpart of ``nfs_tpu/utils/flops.py``): achieved
FLOP/s against the card's peak, beside iterations per second.

The step is dominated by VGG; the renderer's three-shear rotations are
the next term. Elementwise work is left out (memory-bound; MFU is a
compute-roofline metric).

Backward convention: the loss network is frozen, so the backward of a
convolution needs the input gradient only, about the forward's cost: a
forward + backward of frozen VGG counts 2x the forward.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from nfs_tpu_torch.features.vgg import VGG_ARCH

# The JAX package's TPU figures, kept under their names as its record:
# bf16 systolic-array peak of one TPU v5e chip, and its f32 peak
TPU_V5E_PEAK_BF16 = 197e12
TPU_V5E_PEAK_F32 = 49e12
# One NVIDIA H100 SXM5, dense (without sparsity), at its 700 W limit:
# NVIDIA H100 Tensor Core GPU datasheet. bf16 on the tensor cores, and
# float32 outside them
H100_SXM_PEAK_BF16 = 989.4e12
H100_SXM_PEAK_F32 = 66.9e12


def vgg_forward_flops(height: int, width: int,
                      layers: Sequence[str]) -> float:
    """Multiply-add FLOPs (2 * MACs) of one VGG-19 forward over one image,
    only as deep as the deepest requested relu layer (as
    ``vgg_features`` stops there)."""
    deepest = max(layers, key=_layer_order) if layers else None
    h, w, c_in = height, width, 3
    total = 0.0
    for entry in VGG_ARCH:
        if entry == "pool":
            h, w = h // 2, w // 2
            continue
        name, c_out = entry
        total += 2.0 * h * w * 9 * c_in * c_out
        c_in = c_out
        if deepest is not None and f"relu{name[4:]}" == deepest:
            break
    return total


def _layer_order(layer: str) -> Tuple[int, int]:
    block, idx = layer.replace("relu", "").split("_")
    return int(block), int(idx)


def shear_rotate_flops(vol_shape: Sequence[int]) -> float:
    """Three-shear rotation of one volume (``ops/shear.py``): each shear
    applies a (len, len) interpolation matrix along one axis, 2 * len^2 *
    (other axes) FLOPs, three shears per rotation."""
    z, y, x = vol_shape
    return 2.0 * (z * z * y * x) + 2.0 * (y * y * z * x) + 2.0 * (x * x * z * y)


def render_forward_flops(vol_shape: Sequence[int], out_size: Sequence[int],
                         n_views: int) -> float:
    """Per view: one shear rotation and the resize-to-output contraction
    (the march's cumsum and compositing are elementwise, left out)."""
    z, y, x = vol_shape
    oh, ow = out_size
    resize = 2.0 * (oh * (y * x) + ow * oh * x)  # separable contractions
    return n_views * (shear_rotate_flops(vol_shape) + resize)


def styler_step_flops(vol_shape: Sequence[int], render_size: Sequence[int],
                      n_views: int, layers: Sequence[str],
                      n_window_renders: int = 1) -> float:
    """One Adam iteration of the TNST grid styler: render and VGG over
    n_views images, n_window_renders times (1 + 2 * window for the window
    loss), forward and backward (2x, frozen VGG)."""
    fwd = (render_forward_flops(vol_shape, render_size, n_views)
           + n_views * vgg_forward_flops(render_size[0], render_size[1],
                                         layers))
    return 2.0 * fwd * n_window_renders


def mfu(achieved_flops_per_s: float,
        peak: float = H100_SXM_PEAK_BF16) -> float:
    """Fraction of ``peak`` (0..1); the H100 SXM's dense bf16 peak by
    default."""
    return achieved_flops_per_s / peak
