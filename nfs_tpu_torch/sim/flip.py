"""FLIP-lite liquid solver (counterpart of ``nfs_tpu/sim/flip.py``), the
data generator of the LNST particle path:

  P2G (splat mass + momentum) -> gravity -> pressure projection in the
  fluid mask -> solid walls -> G2P with a PIC/FLIP blend -> midpoint
  particle advection, clamped to the domain.

The particle count is fixed; particles are seeded once, with numpy, from
a fluid block (bit-identical to the JAX package's seeding). Splat and
gather are ``ops/splat.py``'s, quadratic B-spline: on a GPU the splat's
``index_add`` sums with float atomics, so runs there agree within a
tolerance, not bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.ops.splat import gather, splat, splat_normalized
from nfs_tpu_torch.sim.smoke import _divergence, _gradient, _jacobi_pressure


@dataclasses.dataclass(frozen=True)
class FlipConfig:
    shape: Tuple[int, ...] = (64, 64)
    gravity: float = 0.15          # cells/frame^2 along +axis0 (down)
    flip_ratio: float = 0.95       # 1 = pure FLIP, 0 = pure PIC
    jacobi_iters: int = 40
    particles_per_cell: int = 4
    # initial fluid block (fractions of shape): lo/hi corners
    block_lo: Tuple[float, ...] = (0.05, 0.3)
    block_hi: Tuple[float, ...] = (0.5, 0.7)
    dt: float = 1.0


def seed_particles(cfg: FlipConfig, seed: int = 0,
                   device="cuda") -> ParticleSet:
    """Jittered uniform seeding inside the initial fluid block."""
    rng = np.random.default_rng(seed)
    ndim = len(cfg.shape)
    lo = np.array([l * s for l, s in zip(cfg.block_lo, cfg.shape)])
    hi = np.array([h * s for h, s in zip(cfg.block_hi, cfg.shape)])
    cells = [np.arange(int(l), int(h)) for l, h in zip(lo, hi)]
    grid = np.stack(np.meshgrid(*cells, indexing="ij"),
                    axis=-1).reshape(-1, ndim)
    pts = np.repeat(grid, cfg.particles_per_cell, axis=0).astype(np.float32)
    pts += rng.random(pts.shape).astype(np.float32)
    x = torch.from_numpy(pts).to(device)
    return ParticleSet(x=x, vel=torch.zeros_like(x),
                       dens=torch.ones(x.shape[0], dtype=torch.float32,
                                       device=x.device))


class FlipSolver:
    def __init__(self, cfg: FlipConfig):
        self.cfg = cfg

    @torch.no_grad()
    def step(self, x: torch.Tensor, vel: torch.Tensor):
        cfg = self.cfg
        shape = cfg.shape
        ndim = x.shape[-1]

        # P2G: mass-weighted velocity splat
        mass = splat(x, torch.ones(x.shape[0], dtype=torch.float32,
                                   device=x.device), shape,
                     kernel="bspline")
        v_grid = splat_normalized(x, vel, shape, kernel="bspline")

        # forces
        v_old = v_grid
        v_grid = v_grid.clone()
        v_grid[..., 0] += cfg.gravity * cfg.dt

        # pressure projection inside the fluid mask
        fluid = mass > 0.25
        div = _divergence(v_grid) * fluid
        p = _jacobi_pressure(div, cfg.jacobi_iters)
        v_grid = v_grid - _gradient(p) * fluid[..., None]

        # solid walls: zero normal velocity at domain faces
        for ax in range(ndim):
            comp = v_grid[..., ax]
            comp.select(ax, 0).clamp_(min=0.0)
            comp.select(ax, shape[ax] - 1).clamp_(max=0.0)

        # G2P: PIC/FLIP blend
        v_pic = gather(v_grid, x, kernel="bspline")
        dv = gather(v_grid - v_old, x, kernel="bspline")
        vel = cfg.flip_ratio * (vel + dv) + (1 - cfg.flip_ratio) * v_pic

        # advect particles (midpoint) and clamp to the domain
        x_mid = x + 0.5 * cfg.dt * vel
        v_mid = gather(v_grid, x_mid, kernel="bspline")
        x = x + cfg.dt * v_mid
        margin = 1.001
        x = torch.stack(
            [torch.clamp(x[..., d], margin, shape[d] - 1 - margin)
             for d in range(ndim)], dim=-1)
        return x, vel


def liquid_sequence(cfg: FlipConfig, n_frames: int, seed: int = 0,
                    device="cuda"):
    """Run FLIP for n_frames on ``device``; returns numpy (positions
    (T, N, nd), velocities (T, N, nd))."""
    solver = FlipSolver(cfg)
    p0 = seed_particles(cfg, seed, device)
    x, vel = p0.x, p0.vel
    xs, vels = [], []
    for _ in range(n_frames):
        x, vel = solver.step(x, vel)
        xs.append(x)
        vels.append(vel)
    return (torch.stack(xs).cpu().numpy(), torch.stack(vels).cpu().numpy())
