"""Operations and bytes the stylization needs, counted from shapes, and the
H100's peaks: the yardstick of ``step_mfu_pct`` and the kernels'
roofline shares.

Frozen copies (parent commit 7a3f9ef):

- :func:`vgg_forward_flops`, :func:`shear_rotate_flops` and the resize
  contraction of :func:`render_flops` follow
  ``nfs_tpu_torch/utils/flops.py``; the peaks are its
  ``H100_SXM_PEAK_BF16`` and ``H100_SXM_PEAK_F32`` (NVIDIA's H100 SXM
  datasheet, dense, at 700 W).
- :data:`ADVECT_FLOATS` and :data:`HBM_BYTES_PER_S` follow
  ``chip_smoke.py`` (``io_floats``, ``HBM_BYTES_PER_S``): each float a
  kernel must read or write once, per cell. :func:`splat_least_s` counts
  the splat's floats the same way, per particle and cell; it leaves out
  ``chip_smoke.py``'s 32-byte sectors of occupied slots, which measure
  the program's slot layout rather than the splat's need.

Which peak bounds which work: the convolutions run in bfloat16 on the
tensor cores. The Gram products take bfloat16 features, exact in a
float32 accumulation, so they are bounded by the bfloat16 peak too: a
lower bound on their time. The shear and resize products take float32
densities with TF32 off, so they are bounded by the float32 peak.
Elementwise work (the march, the losses, Adam) is left out: it bounds
nothing by operations. The frozen loss network needs the input gradient
only, so a forward and backward count twice the forward, for the
convolutions, the Gram and the render alike.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_BF16 = 989.4e12
PEAK_F32 = 66.9e12
HBM_BYTES_PER_S = 3.35e12

# floats per cell each advection kernel reads or writes once: K1 reads the
# field (1) and the displacement (3), writes 1; K2 reads the cotangent and
# the displacement, writes the field's gradient
ADVECT_FLOATS = {"fwd": 5, "bwd_field": 5, "bwd_vel": 8, "bwd_fused": 9}

# (name, out channels) of VGG-19, 'pool' for a 2x2 pooling
VGG_ARCH = (
    ("conv1_1", 64), ("conv1_2", 64), "pool",
    ("conv2_1", 128), ("conv2_2", 128), "pool",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    "pool",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    "pool",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
)


def vgg_forward_flops(h: int, w: int, deepest: str) -> float:
    """2 * multiply-adds of one image through VGG-19 down to the relu
    layer ``deepest`` (3x3 convolutions, SAME padding)."""
    c_in, total = 3, 0.0
    for e in VGG_ARCH:
        if e == "pool":
            h, w = h // 2, w // 2
            continue
        name, c_out = e
        total += 2.0 * h * w * 9 * c_in * c_out
        c_in = c_out
        if f"relu{name[4:]}" == deepest:
            return total
    raise ValueError(f"no layer {deepest}")


def layer_shapes(h: int, w: int, layers: Sequence[str]) -> Dict[str, Tuple]:
    """(height, width, channels) of each requested relu layer."""
    out, c = {}, 3
    for e in VGG_ARCH:
        if e == "pool":
            h, w = h // 2, w // 2
            continue
        c = e[1]
        if f"relu{e[0][4:]}" in layers:
            out[f"relu{e[0][4:]}"] = (h, w, c)
    return out


def gram_flops(h: int, w: int, layers: Sequence[str]) -> float:
    """One image's Gram matrices, F^T F per layer: 2 * C^2 * H * W."""
    return sum(2.0 * c * c * hh * ww
               for hh, ww, c in layer_shapes(h, w, layers).values())


def shear_rotate_flops(shape: Sequence[int]) -> float:
    """The rotation of one volume: azimuth in the (z, x) plane, then
    elevation in the (z, y) plane, three shears each; a shear is a dense
    (S, S) matrix along its move axis, 2 * S^2 * (the other axes).
    ``utils/flops.py`` counts three shears, one per axis; the program
    runs six."""
    z, y, x = shape
    zz, yy, xx = (2.0 * n * n * (z * y * x // n) for n in (z, y, x))
    return 2 * zz + xx + 2 * zz + yy


def render_flops(shape: Sequence[int], out_size: Sequence[int]) -> float:
    """One view: the shear rotation and the separable resize of the
    (H, W) image to ``out_size``."""
    _, y, x = shape
    oh, ow = out_size
    return shear_rotate_flops(shape) + 2.0 * (oh * (y * x) + ow * oh * x)


def tnst_iteration_least_s(shape, out_size, views: int, positions: int,
                           layers: Sequence[str]) -> float:
    """Least seconds of one Adam iteration of a TNST grid frame: every
    window position's views rendered and pushed through VGG and the Gram,
    forward and backward."""
    deepest = max(layers, key=lambda l: tuple(map(int, l[4:].split("_"))))
    images = views * positions
    bf16 = images * (vgg_forward_flops(out_size[0], out_size[1], deepest)
                     + gram_flops(out_size[0], out_size[1], layers))
    f32 = images * render_flops(shape, out_size)
    return 2.0 * (bf16 / PEAK_BF16 + f32 / PEAK_F32)


def advect_least_s(kind: str, cells: int, frames: int = 1) -> float:
    """Least seconds of one advection kernel over ``frames`` frames of
    ``cells`` cells: its bytes once, at the HBM bandwidth."""
    return 4.0 * ADVECT_FLOATS[kind] * cells * frames / HBM_BYTES_PER_S


def splat_least_s(cells: int, n: int, backward: bool) -> float:
    """Least seconds of one B-spline splat of ``n`` particles onto a grid
    of ``cells`` cells, at the HBM bandwidth: the forward reads each
    particle's position and density once and writes the grid; the
    backward reads them and the grid's gradient and writes each
    particle's four gradients. The program's slot layout, empty slots and
    all, is not counted: it is the program's choice, not the algorithm's
    need."""
    floats = (8 * n if backward else 4 * n) + cells
    return 4.0 * floats / HBM_BYTES_PER_S
