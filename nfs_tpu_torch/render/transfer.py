"""Density -> RGB transfer functions for coloured smoke (counterpart of
``nfs_tpu/render/transfer.py``).

A transfer function is N RGB control points spread evenly over densities
[0, d_max], evaluated as a hat-basis expansion:

    t     = clip(rho / d_max, 0, 1) * (N - 1)
    w_i   = max(0, 1 - |t - i|)            (partition of unity on [0, N-1])
    color = sum_i w_i * c_i                (== piecewise-linear interp)

It is differentiable in the density and in the control points, so the
grid styler can train the points (``render.train_transfer``). The clip and
the hat carry JAX's subgradients at their ties (0.5 at a clip bound,
abs'(0) = +1 and 0.5 where ``max(0, .)`` ties; ROADMAP queue 3, F1, F2
and F6): a density of exactly 0 sits on both.

The colormap table and ``tf_from_image`` are copies of the JAX package's,
so both packages colour a density alike.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nfs_tpu_torch.ops.jaxgrad import jax_clip, jax_tent

# Builtin control-point tables (N, 3), RGB in [0, 1], low -> high density.
COLORMAPS = {
    # black -> deep red -> orange -> yellow -> white (fire/blackbody)
    "fire": np.array([
        [0.00, 0.00, 0.00], [0.25, 0.02, 0.01], [0.55, 0.08, 0.02],
        [0.85, 0.25, 0.03], [1.00, 0.45, 0.05], [1.00, 0.65, 0.15],
        [1.00, 0.85, 0.45], [1.00, 1.00, 0.90],
    ], np.float32),
    # black -> deep blue -> cyan -> white (cold smoke / ice)
    "ice": np.array([
        [0.00, 0.00, 0.00], [0.02, 0.05, 0.20], [0.05, 0.15, 0.45],
        [0.10, 0.35, 0.70], [0.25, 0.55, 0.85], [0.45, 0.75, 0.95],
        [0.70, 0.90, 1.00], [0.95, 1.00, 1.00],
    ], np.float32),
    # perceptually-ordered dark purple -> green -> yellow
    "viridis": np.array([
        [0.267, 0.005, 0.329], [0.283, 0.131, 0.449],
        [0.254, 0.265, 0.530], [0.207, 0.372, 0.553],
        [0.164, 0.471, 0.558], [0.128, 0.567, 0.551],
        [0.135, 0.659, 0.518], [0.993, 0.906, 0.144],
    ], np.float32),
    # neutral: identity grayscale ramp (useful for A/B tests)
    "gray": np.repeat(np.linspace(0.0, 1.0, 8,
                                  dtype=np.float32)[:, None], 3, axis=1),
}


def transfer_colors(rho: torch.Tensor, nodes: torch.Tensor,
                    d_max: float = 1.0) -> torch.Tensor:
    """Map density to RGB through the hat basis.

    Args:
      rho: density, any shape (...,).
      nodes: (N, 3) RGB control points, uniform over [0, d_max].
      d_max: density mapped to the last node (higher values clamp).

    Returns:
      (..., 3) float32 colours.
    """
    n = nodes.shape[0]
    t = jax_clip(rho / float(np.float32(d_max)), 0.0, 1.0) * float(
        n - 1)
    color = torch.zeros(rho.shape + (3,), dtype=torch.float32,
                        device=rho.device)
    for i in range(n):
        w = jax_tent(t - float(i))
        color = color + w[..., None] * nodes[i]
    return color


def tf_from_image(path: str, n_nodes: int = 8) -> np.ndarray:
    """Sample a TF's control points from an image: the middle row is read
    as a left (low density) -> right (high) gradient."""
    from nfs_tpu_torch.io.image import load_image

    img = np.asarray(load_image(path))
    row = img[img.shape[0] // 2]                    # (W, 3)
    xs = np.linspace(0, row.shape[0] - 1, n_nodes)
    lo = np.floor(xs).astype(np.int64)
    hi = np.minimum(lo + 1, row.shape[0] - 1)
    f = (xs - lo).astype(np.float32)[:, None]
    return ((1.0 - f) * row[lo, :3] + f * row[hi, :3]).astype(np.float32)


def resolve_transfer(name: Optional[str],
                     n_nodes: int = 8) -> Optional[np.ndarray]:
    """Config string -> (N, 3) nodes: a builtin colormap name, a path to
    a gradient image, a trained-nodes ``.npz`` (``nodes`` key, the
    ``tf_%04d.npz`` export of ``render.train_transfer``), or None
    (grayscale rendering)."""
    if name is None or name == "":
        return None
    if name in COLORMAPS:
        return COLORMAPS[name]
    if name.endswith(".npz"):
        with np.load(name) as z:
            return np.asarray(z["nodes"], np.float32)
    return tf_from_image(name, n_nodes)
