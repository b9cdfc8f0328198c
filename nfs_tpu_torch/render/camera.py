"""Camera view-angle sampling (counterpart of
``nfs_tpu/render/camera.py``; TNST §5 multi-view Poisson-disk sampling).

- :func:`poisson_view_pool` — Bridson dart throwing on the (theta, phi)
  rectangle, run on the host in numpy. The code is the JAX package's,
  line for line, so both packages build the SAME pool from the same seed.
  The styler ships the pool to the device once and indexes it per
  iteration.
- :func:`sample_views_stratified` — one jittered sample per stratum of
  the angle rectangle, drawn from an explicit ``torch.Generator``.

Angles are returned in **radians**, shape (n, 2) as (theta, phi).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def poisson_disk_2d(n: int, lo: Tuple[float, float], hi: Tuple[float, float],
                    rng: np.random.Generator, k: int = 30) -> np.ndarray:
    """Bridson Poisson-disk sampling of `n` points in the box [lo, hi].

    The disk radius is chosen from the box area so that ~n points fit
    (r = sqrt(A / (2*sqrt(3)*n)), hex-packing density); if dart throwing
    stalls before n points, the radius shrinks and sampling restarts.
    Returns (n, 2) float32. Degenerate boxes (zero extent) fall back to
    uniform jitter on the non-degenerate axes.
    """
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    ext = np.maximum(hi - lo, 0.0)
    if n <= 0:
        return np.zeros((0, 2), np.float32)
    if ext[0] * ext[1] <= 0.0:  # degenerate: uniform on the line/point
        pts = lo[None, :] + rng.random((n, 2)) * ext[None, :]
        return pts.astype(np.float32)

    area = ext[0] * ext[1]
    r = math.sqrt(area / (2.0 * math.sqrt(3.0) * n))
    for _ in range(8):  # shrink-and-retry
        pts = _bridson(n, lo, hi, r, rng, k)
        if pts.shape[0] >= n:
            return pts[:n].astype(np.float32)
        r *= 0.8
    # last resort: top up with uniform samples
    extra = lo[None, :] + rng.random((n - pts.shape[0], 2)) * ext[None, :]
    return np.concatenate([pts, extra], axis=0).astype(np.float32)


def _bridson(n, lo, hi, r, rng, k):
    cell = r / math.sqrt(2.0)
    gw = int(np.ceil((hi[0] - lo[0]) / cell)) + 1
    gh = int(np.ceil((hi[1] - lo[1]) / cell)) + 1
    grid = -np.ones((gw, gh), dtype=np.int64)
    pts = []
    active = []

    def gidx(p):
        return (int((p[0] - lo[0]) / cell), int((p[1] - lo[1]) / cell))

    def fits(p):
        gx, gy = gidx(p)
        x0, x1 = max(gx - 2, 0), min(gx + 3, gw)
        y0, y1 = max(gy - 2, 0), min(gy + 3, gh)
        for xx in range(x0, x1):
            for yy in range(y0, y1):
                j = grid[xx, yy]
                if j >= 0:
                    q = pts[j]
                    if (p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 < r * r:
                        return False
        return True

    p0 = lo + rng.random(2) * (hi - lo)
    pts.append(p0)
    active.append(0)
    grid[gidx(p0)] = 0

    while active and len(pts) < n:
        ai = rng.integers(len(active))
        base = pts[active[ai]]
        found = False
        for _ in range(k):
            ang = rng.random() * 2 * math.pi
            rad = r * (1.0 + rng.random())
            cand = base + rad * np.array([math.cos(ang), math.sin(ang)])
            if (cand >= lo).all() and (cand <= hi).all() and fits(cand):
                grid[gidx(cand)] = len(pts)
                pts.append(cand)
                active.append(len(pts) - 1)
                found = True
                break
        if not found:
            active.pop(ai)
    return np.asarray(pts, dtype=np.float64).reshape(-1, 2)


def poisson_view_pool(pool_size: int, n_views: int,
                      theta_range: Tuple[float, float],
                      phi_range: Tuple[float, float],
                      seed: int = 0) -> np.ndarray:
    """Precompute `pool_size` Poisson-disk view sets.

    Angle ranges are in DEGREES (the reference's flag convention); output is
    (pool_size, n_views, 2) RADIANS (theta, phi), ready to ship to device.
    """
    rng = np.random.default_rng(seed)
    lo = (math.radians(theta_range[0]), math.radians(phi_range[0]))
    hi = (math.radians(theta_range[1]), math.radians(phi_range[1]))
    pool = np.stack(
        [poisson_disk_2d(n_views, lo, hi, rng) for _ in range(pool_size)])
    return pool.astype(np.float32)


def sample_views_stratified(generator: torch.Generator, n_views: int,
                            theta_range: Tuple[float, float],
                            phi_range: Tuple[float, float],
                            device="cpu") -> torch.Tensor:
    """Stratified-jitter view sampling: the (theta, phi) rectangle split
    into an ~sqrt(n) x sqrt(n) grid of strata, one jittered sample in
    each, in random order. Ranges in DEGREES, output (n_views, 2)
    RADIANS on ``device``; the draws come from ``generator`` (CPU)."""
    gw = int(math.ceil(math.sqrt(n_views)))
    gh = int(math.ceil(n_views / gw))
    gi, gj = torch.meshgrid(torch.arange(gw), torch.arange(gh),
                            indexing="ij")
    cells = torch.stack([gi, gj], dim=-1).reshape(-1, 2)[:n_views].float()
    u = torch.rand((n_views, 2), generator=generator)
    frac = (cells + u) / torch.tensor([gw, gh], dtype=torch.float32)
    frac = frac[torch.randperm(n_views, generator=generator)]
    lo = torch.tensor([math.radians(theta_range[0]),
                       math.radians(phi_range[0])])
    hi = torch.tensor([math.radians(theta_range[1]),
                       math.radians(phi_range[1])])
    return (lo + frac * (hi - lo)).to(device)
