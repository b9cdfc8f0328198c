"""Quality metrics for stylized fields (counterpart of
``nfs_tpu/eval/quality.py``).

TNST §6 judges temporal coherence by warping frame t through the sim
velocity and comparing it with frame t+1; the Gram distance to the style
image's Gram matrices is the optimization objective itself (TNST §4), so
its convergence curve says whether a run stylized.

Each metric reduces on the device of its inputs (the CPU for arrays)
under ``torch.no_grad`` and returns Python floats, as the JAX package's
do.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nfs_tpu_torch.features.losses import gram_matrix
from nfs_tpu_torch.features.vgg import vgg_features
from nfs_tpu_torch.ops.advect import advect


def _f32(x, device=None) -> torch.Tensor:
    """float32 tensor on ``device``; by default a tensor stays where it is
    and an array goes to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@torch.no_grad()
def temporal_coherence(frames, velocities,
                       max_disp: Optional[float] = 2.0) -> Dict[str, float]:
    """Warped-frame error of a stylized sequence (TNST §6 criterion).

    For each t, frame t is advected through the sim velocity and compared
    with frame t+1, relative to the no-warp frame difference: ``ratio``
    < 1 means the stylization moves with the flow; ~1 means it ignores
    it.

    Args:
      frames: (T, *spatial) stylized densities.
      velocities: (T, *spatial, ndim) frame-to-frame sim velocities
        (cells/frame, array-axis order).
      max_disp: the advection's displacement bound (None = exact path).

    Returns dict: warped_mse, static_mse, ratio.
    """
    frames = _f32(frames)
    velocities = _f32(velocities, frames.device)
    wm, sm = [], []
    for t in range(frames.shape[0] - 1):
        warped = advect(frames[t], velocities[t], max_disp=max_disp)
        wm.append(torch.mean((frames[t + 1] - warped) ** 2))
        sm.append(torch.mean((frames[t + 1] - frames[t]) ** 2))
    warped_mse = float(torch.stack(wm).mean())
    static_mse = float(torch.stack(sm).mean())
    return {
        "warped_mse": warped_mse,
        "static_mse": static_mse,
        "ratio": warped_mse / max(static_mse, 1e-12),
    }


def coherence_gate(stylized_ratio: float, sim_ratio: float,
                   factor: float = 3.0) -> bool:
    """Pass/fail for sequence coherence: the stylized sequence must track
    the flow within ``factor``x of the sim's own transport residual (the
    floor that advection and boundary error leave)."""
    return bool(stylized_ratio < factor * sim_ratio)


@torch.no_grad()
def gram_distance(vgg_params, images, target_grams: Dict[str, torch.Tensor],
                  layers: Sequence[str], dtype=None) -> float:
    """Mean per-layer Gram MSE of rendered (N, H, W, 3) images against the
    style targets: the style objective itself, evaluated as a metric.
    ``dtype`` is VGG's compute dtype (None = float32)."""
    device = next(iter(vgg_params.values()))["w"].device
    feats = vgg_features(vgg_params, _f32(images, device), tuple(layers),
                         dtype=dtype)
    total = 0.0
    for layer in layers:
        g = gram_matrix(feats[layer])
        gt = target_grams[layer].to(torch.float32)
        total += float(torch.mean((g - gt) ** 2))
    return total / len(layers)


def gram_convergence(octave_losses: Sequence) -> Dict[str, object]:
    """Per-octave loss curves of a styler run: initial and final loss per
    octave, the total drop, and the fraction of iterations that lowered
    the loss (a flat or diverging run shows here)."""
    curves = [np.asarray(l.cpu() if isinstance(l, torch.Tensor) else l,
                         np.float64) for l in octave_losses]
    per_octave = []
    dec, tot = 0, 0
    for c in curves:
        if c.size == 0:
            continue
        per_octave.append({
            "initial": float(c[0]),
            "final": float(c[-1]),
            "drop_pct": float(100.0 * (c[0] - c[-1]) / max(c[0], 1e-12)),
        })
        d = np.diff(c)
        dec += int((d < 0).sum())
        tot += d.size
    overall = 0.0
    if per_octave:
        first = per_octave[0]["initial"]
        overall = 100.0 * (first - per_octave[-1]["final"]) / max(first,
                                                                  1e-12)
    return {
        "per_octave": per_octave,
        "overall_drop_pct": float(overall),
        "decreasing_iter_frac": float(dec / max(tot, 1)),
    }


@torch.no_grad()
def stylization_strength(d_star, d) -> Dict[str, float]:
    """How much the stylization changed the field, scale-normalized:
    catches a run that did nothing."""
    d_star = _f32(d_star)
    d = _f32(d, d_star.device)
    diff = torch.abs(d_star - d)
    base = torch.mean(torch.abs(d)) + 1e-12
    return {
        "mean_abs_change": float(torch.mean(diff)),
        "rel_change": float(torch.mean(diff) / base),
        "max_abs_change": float(torch.max(diff)),
    }
