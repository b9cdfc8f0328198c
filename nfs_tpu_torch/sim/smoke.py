"""Smoke solver (counterpart of ``nfs_tpu/sim/smoke.py``): inflow ->
advect (MacCormack for the velocity) -> buoyancy -> vorticity confinement
-> Jacobi pressure projection, on a cell-centred collocated grid, in 2D
(H, W) and 3D (D, H, W).

Each step runs under ``torch.no_grad()``, so the advection saves nothing
for a backward. In 3D the density advection and the channelled MacCormack
of the velocity go through ``ops/advect.py``, i.e. the CUDA kernel K1 on
a GPU: one launch for the density and 3 channels x 2 passes for the
velocity, 7 per step. 2D grids take the window-tap sum. ``torch.roll`` is
periodic, as ``jnp.roll`` is. The solver runs eagerly, one small kernel
per stencil term: at 3D sizes a step is bound by launches, not by the
device.

The 3D smoke plume at the north-star size is 112x64x112 x 200 frames; 2D
is 256x192.
"""

from __future__ import annotations

import dataclasses
import glob
import math
import os
import shutil
import time
from typing import Optional, Tuple

import numpy as np
import torch

from nfs_tpu_torch.io.stream import (finalize_sequence_dir,
                                     sequence_cache_complete)
from nfs_tpu_torch.ops.advect import advect, advect_maccormack


def _divergence(v: torch.Tensor) -> torch.Tensor:
    """Central-difference divergence of a collocated velocity field."""
    ndim = v.shape[-1]
    div = torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)
    for ax in range(ndim):
        comp = v[..., ax]
        fwd = torch.roll(comp, -1, ax)
        bwd = torch.roll(comp, 1, ax)
        div = div + (fwd - bwd) * 0.5
    return div


def _gradient(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([(torch.roll(p, -1, ax) - torch.roll(p, 1, ax)) * 0.5
                        for ax in range(p.ndim)], dim=-1)


def _jacobi_pressure(div: torch.Tensor, iters: int) -> torch.Tensor:
    """Solve lap(p) = div with ``iters`` Jacobi sweeps (periodic rolls;
    adequate for generating style-transfer input data)."""
    ndim = div.ndim
    inv = 1.0 / (2.0 * ndim)
    p = torch.zeros_like(div)
    for _ in range(iters):
        acc = torch.zeros_like(p)
        for ax in range(ndim):
            acc = acc + torch.roll(p, 1, ax) + torch.roll(p, -1, ax)
        p = (acc - div) * inv
    return p


def _central_diff(f: torch.Tensor, axis: int) -> torch.Tensor:
    return (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) * 0.5


def _vorticity_confinement_3d(v: torch.Tensor, eps: float) -> torch.Tensor:
    """3D vorticity confinement (Fedkiw et al.): f = eps * (N x omega)
    with N = grad|omega| / |grad|omega||. Axis order (z, y, x), channels
    (vz, vy, vx)."""
    vz, vy, vx = v[..., 0], v[..., 1], v[..., 2]
    wz = _central_diff(vx, 1) - _central_diff(vy, 2)
    wy = _central_diff(vz, 2) - _central_diff(vx, 0)
    wx = _central_diff(vy, 0) - _central_diff(vz, 1)
    mag = torch.sqrt(wz ** 2 + wy ** 2 + wx ** 2)
    nz = _central_diff(mag, 0)
    ny = _central_diff(mag, 1)
    nx = _central_diff(mag, 2)
    nmag = torch.sqrt(nz ** 2 + ny ** 2 + nx ** 2) + 1e-6
    nz, ny, nx = nz / nmag, ny / nmag, nx / nmag
    fz = ny * wx - nx * wy
    fy = nx * wz - nz * wx
    fx = nz * wy - ny * wz
    return eps * torch.stack([fz, fy, fx], dim=-1)


def _vorticity_confinement_2d(v: torch.Tensor, eps: float) -> torch.Tensor:
    """2D vorticity confinement force."""
    vy, vx = v[..., 0], v[..., 1]
    dvx_dy = (torch.roll(vx, -1, 0) - torch.roll(vx, 1, 0)) * 0.5
    dvy_dx = (torch.roll(vy, -1, 1) - torch.roll(vy, 1, 1)) * 0.5
    w = dvy_dx - dvx_dy
    aw = torch.abs(w)
    gy = (torch.roll(aw, -1, 0) - torch.roll(aw, 1, 0)) * 0.5
    gx = (torch.roll(aw, -1, 1) - torch.roll(aw, 1, 1)) * 0.5
    mag = torch.sqrt(gx ** 2 + gy ** 2) + 1e-6
    nx, ny = gx / mag, gy / mag
    return eps * torch.stack([-nx * w, ny * w], dim=-1)


@dataclasses.dataclass(frozen=True)
class SmokeConfig:
    shape: Tuple[int, ...] = (64, 48)
    buoyancy: float = 0.25
    vorticity: float = 0.1
    jacobi_iters: int = 40
    dissipation: float = 0.0
    # inflow: gaussian blob source position (fractions of shape) + radius
    source_center: Tuple[float, ...] = (0.85, 0.5)
    source_radius: float = 0.08
    source_rate: float = 0.6
    dt: float = 1.0
    # displacement bound of the window advection (ops/advect.py)
    max_disp: float = 3.0


class SmokeSolver:
    """Stateless stepper on ``device``: (d, v) -> (d, v). Buoyancy pushes
    along -axis0 for 2D grids (index 0 grows downward in image
    convention) and -axis1 (vertical y) for 3D (z, y, x) grids."""

    def __init__(self, cfg: SmokeConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        shape = cfg.shape
        centers = [c * (s - 1) for c, s in zip(cfg.source_center, shape)]
        axes = [torch.arange(s, dtype=torch.float32, device=self.device)
                for s in shape]
        mesh = torch.meshgrid(*axes, indexing="ij")
        r2 = sum(((m - c) / (cfg.source_radius * max(shape))) ** 2
                 for m, c in zip(mesh, centers))
        self.source = torch.exp(-r2)
        self.up_axis = 0 if len(shape) == 2 else 1

    def initial_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = self.cfg.shape
        return (torch.zeros(shape, dtype=torch.float32, device=self.device),
                torch.zeros(shape + (len(shape),), dtype=torch.float32,
                            device=self.device))

    @torch.no_grad()
    def step(self, d: torch.Tensor, v: torch.Tensor):
        cfg = self.cfg
        ndim = d.ndim
        # 1. inflow
        d = torch.clamp(d + cfg.source_rate * self.source * cfg.dt, 0.0, 2.0)
        # 2. advect density, and velocity with one channelled MacCormack
        d = advect(d, v, dt=cfg.dt, max_disp=cfg.max_disp)
        v = advect_maccormack(v, v, dt=cfg.dt, max_disp=cfg.max_disp)
        # 3. buoyancy (up = negative index direction on the up axis)
        v[..., self.up_axis] += -cfg.buoyancy * d * cfg.dt
        # 4. vorticity confinement
        if cfg.vorticity > 0:
            if ndim == 2:
                v = v + cfg.dt * _vorticity_confinement_2d(v, cfg.vorticity)
            else:
                v = v + cfg.dt * _vorticity_confinement_3d(v, cfg.vorticity)
        # 5. pressure projection
        p = _jacobi_pressure(_divergence(v), cfg.jacobi_iters)
        v = v - _gradient(p)
        # 6. dissipation
        if cfg.dissipation > 0:
            d = d * (1.0 - cfg.dissipation)
        return d, v


def _run(solver: SmokeSolver, d, v, steps: int):
    """``steps`` solver steps; (d, v, densities (steps, ...) and
    velocities (steps, ...) as numpy)."""
    ds, vs = [], []
    for _ in range(steps):
        d, v = solver.step(d, v)
        ds.append(d)
        vs.append(v)
    return d, v, torch.stack(ds).cpu().numpy(), torch.stack(vs).cpu().numpy()


def _warm_up(solver: SmokeSolver, d, v, warmup: int, chunk: int):
    """``warmup`` discarded steps, rounded UP to a multiple of ``chunk``
    as the JAX package's chunked scan runs them."""
    for _ in range(math.ceil(warmup / chunk) * chunk):
        d, v = solver.step(d, v)
    return d, v


def smoke_sequence(cfg: SmokeConfig, n_frames: int, warmup: int = 0,
                   chunk: int = 16, device="cuda"
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the solver for n_frames (after ``warmup`` discarded steps,
    rounded up to a multiple of ``chunk``) on ``device``; returns
    (densities (T, *shape), velocities (T, *shape, nd)) as numpy. Frames
    come back to the host one chunk at a time, so device memory holds
    O(chunk) frames."""
    solver = SmokeSolver(cfg, device)
    d, v = _warm_up(solver, *solver.initial_state(), warmup, chunk)
    out_d, out_v = [], []
    done = 0
    while done < n_frames:
        take = min(chunk, n_frames - done)
        d, v, ds, vs = _run(solver, d, v, take)
        out_d.append(ds)
        out_v.append(vs)
        done += take
    return np.concatenate(out_d), np.concatenate(out_v)


def smoke_sequence_cached(cfg: SmokeConfig, n_frames: int,
                          cache_path: str, warmup: int = 0,
                          chunk: int = 16,
                          budget_s: Optional[float] = None,
                          device="cuda") -> bool:
    """Resumable :func:`smoke_sequence`: chunk outputs and the solver
    carry state stream to disk, so generation survives interruption.

    Returns True when ``cache_path`` holds the complete sequence; False
    when the time budget ran out mid-way (call again to continue; the
    result is bit-identical to an uninterrupted run since the carried
    state round-trips exactly).

    A ``cache_path`` ending in ``.npz`` finalizes to one monolithic file;
    any other path finalizes AS the chunk directory read by
    ``nfs_tpu_torch.io.stream`` (``meta.json``, ``chunk_%05d.npz`` with
    ``d``/``v``, the JAX package's layout).
    """
    t0 = time.time()
    as_dir = not cache_path.endswith(".npz")
    part_dir = cache_path if as_dir else cache_path + ".part"
    state_path = os.path.join(part_dir, "state.npz")
    if sequence_cache_complete(cache_path):
        return True
    solver = SmokeSolver(cfg, device)
    os.makedirs(part_dir, exist_ok=True)
    if os.path.exists(state_path):
        with np.load(state_path) as z:
            d = torch.from_numpy(z["carry_d"]).to(solver.device)
            v = torch.from_numpy(z["carry_v"]).to(solver.device)
            done = int(z["done"])
    else:
        d, v = _warm_up(solver, *solver.initial_state(), warmup, chunk)
        done = 0

    while done < n_frames:
        tc = time.time()
        take = min(chunk, n_frames - done)
        d, v, ds, vs = _run(solver, d, v, take)
        # append-only chunk files + a small carry state: O(chunk) IO per
        # chunk. The tmp name must NOT match the chunk_*.npz glob, or a
        # stale tmp from a killed run would be read back as data.
        tmp = os.path.join(part_dir, "tmp_chunk.npz")
        np.savez(tmp, d=ds, v=vs)
        os.replace(tmp, os.path.join(part_dir, f"chunk_{done:05d}.npz"))
        done += take
        np.savez(os.path.join(part_dir, "state_tmp.npz"),
                 carry_d=d.cpu().numpy(), carry_v=v.cpu().numpy(), done=done)
        os.replace(os.path.join(part_dir, "state_tmp.npz"), state_path)
        print(f"  sim frames {done}/{n_frames}: {time.time() - tc:.1f}s",
              flush=True)
        if budget_s is not None and time.time() - t0 > budget_s:
            if done < n_frames:
                return False
    if as_dir:
        os.unlink(state_path)
        finalize_sequence_dir(part_dir, n_frames, chunk)
        return True
    chunks = sorted(glob.glob(os.path.join(part_dir, "chunk_*.npz")))
    ds = np.concatenate([np.load(c)["d"] for c in chunks])[:n_frames]
    vs = np.concatenate([np.load(c)["v"] for c in chunks])[:n_frames]
    np.savez(cache_path + ".tmp.npz", d=ds, v=vs)
    os.replace(cache_path + ".tmp.npz", cache_path)
    shutil.rmtree(part_dir, ignore_errors=True)
    return True
