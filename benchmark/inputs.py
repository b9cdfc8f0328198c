"""Inputs of every cell, made from ``--seed`` on the device: the loss
network's weights, the style image, the smoke frames and the view draws.
The program and the reference receive the same tensors.

Frozen copies, so that a change to the program cannot move the inputs:

- :func:`plume_density` and :func:`swirl_velocity` follow
  ``chip_smoke.py`` ``_plume_density`` and ``_swirl_velocity`` (parent
  commit 7a3f9ef), moved to torch on the device. The plume's drift is
  folded into a period of :data:`PLUME_PERIOD` frames (a triangle wave),
  so that a 200-frame job keeps its blob inside the grid.
- :func:`particle_frames` follows ``chip_smoke.py`` ``_bench_particles``
  and ``_particle_frames`` (the particles_3d scene of
  ``bench/full_bench.py:194-285``): uniform particles in the box
  [8, 88] x [8, 56] x [8, 88], advected by a swirl about the grid's centre
  with an explicit step of 0.02, in float32, on the device.
- :func:`vgg_weights` draws the He-normal network of
  ``nfs_tpu_torch/features/vgg.py`` ``init_vgg_params`` (conv weights
  ``N(0, 2 / (9 c_in))``, zero biases), in one draw on the device.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# (name, out_channels) of VGG-19's convolutions up to conv5_1, the deepest
# one a relu1_1-relu5_1 style loss reaches
VGG_CONVS: Tuple[Tuple[str, int], ...] = (
    ("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128), ("conv2_2", 128),
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    ("conv5_1", 512))

PLUME_PERIOD = 32


def generator(seed: int, *stream: int, device="cuda") -> torch.Generator:
    """A generator on ``device`` keyed on (seed, *stream): each input draws
    from its own stream, so adding one moves no other."""
    state = np.random.SeedSequence([int(seed) % 2 ** 63, *stream])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, np.uint64)[0]) % 2 ** 63)


def vgg_weights(seed: int, layers, device="cuda"
                ) -> Dict[str, Dict[str, torch.Tensor]]:
    """He-normal float32 weights, OIHW, of the convolutions up to the
    deepest relu layer in ``layers``, in one draw."""
    deepest = max(int(l[4]) * 10 + int(l[6]) for l in layers)
    convs = [c for c in VGG_CONVS
             if int(c[0][4]) * 10 + int(c[0][6]) <= deepest]
    shapes, c_in = [], 3
    for _, c_out in convs:
        shapes.append((c_out, c_in, 3, 3))
        c_in = c_out
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, 1, device=device),
                       device=device)
    params = {}
    for (name, c_out), shape, w in zip(convs, shapes,
                                       torch.split(flat, sizes)):
        params[name] = {
            "w": (w.view(shape) * math.sqrt(2.0 / (9 * shape[1]))),
            "b": torch.zeros(c_out, device=device)}
    return params


def style_image(name: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] of ``configs/<name>``: an RGB uint8
    array, stored as ``.npy`` so that no image library is needed
    (``fire.npy`` is ``data/styles/fire.png`` of commit 7a3f9ef, decoded;
    the renders are 256 x 256, its own size, so it is not resized)."""
    return (np.load(HERE / "configs" / name) / 255.0).astype(np.float32)


def _axes(shape, device, lo=None, hi=None):
    """Per-axis coordinates broadcast over (D, H, W): indices, or
    ``linspace(lo, hi)`` along each axis."""
    out = []
    for a, n in enumerate(shape):
        view = [1, 1, 1]
        view[a] = n
        c = (torch.arange(n, dtype=torch.float32, device=device)
             if lo is None else
             torch.linspace(lo, hi, n, dtype=torch.float32, device=device))
        out.append(c.view(view))
    return out


def plume_density(shape, frames: int, seed: int, job: int,
                  device="cuda") -> torch.Tensor:
    """(T, D, H, W) densities: a Gaussian blob of peak 2 drifting in y and
    x, times (1 + 10% uniform noise) drawn from (seed, job)."""
    z, y, x = _axes(shape, device, -1.0, 1.0)
    t = torch.arange(frames, dtype=torch.float32, device=device)
    phase = torch.remainder(t, 2 * PLUME_PERIOD)
    drift = 0.05 * torch.minimum(phase, 2 * PLUME_PERIOD - phase)
    drift = drift.view(frames, 1, 1, 1)
    blob = 2.0 * torch.exp(-4.0 * (z ** 2 + (y + 0.3 - drift) ** 2
                                   + (x - drift) ** 2))
    noise = torch.rand((frames,) + tuple(shape),
                       generator=generator(seed, 2, job, device=device),
                       device=device)
    return blob * (1.0 + 0.1 * noise)


def swirl_velocity(shape, frames: int, cap: float,
                   device="cuda") -> torch.Tensor:
    """(T, D, H, W, 3) velocities in cells per frame, array-axis order
    (vz, vy, vx): a swirl about the y axis, growing with t, plus a slow
    rise, each vector's norm capped at ``cap``."""
    z, _, x = _axes(shape, device)
    D, H, W = shape
    dz, dx = z - (D - 1) / 2.0, x - (W - 1) / 2.0
    dz, dx = torch.broadcast_tensors(dz, dx)
    r = torch.sqrt(dz ** 2 + dx ** 2) + 1e-6
    rmax = min(D, W) / 2.0
    base = 1.2 * (r / rmax) * torch.exp(1.0 - r / rmax)
    out = []
    for t in range(frames):
        speed = base * (1.0 + 0.1 * t)
        v = torch.stack([-dx / r * speed, 0.4 * torch.ones_like(r),
                         dz / r * speed], dim=-1)
        norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = v * torch.clamp(cap / torch.clamp(norm, min=1e-6), max=1.0)
        out.append(v.expand(D, H, W, 3))
    return torch.stack(out).contiguous()


def view_schedule(seed: int, job: int, frames: int, octaves: int,
                  iters: int, positions: int, pool: int) -> np.ndarray:
    """(T, octaves, iters, positions) view-pool indices drawn from
    (seed, job), uniform over the pool."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 3, job])
    return rng.integers(0, pool, size=(frames, octaves, iters, positions))


def particle_frames(n: int, frames: int, seed: int, job: int, box_lo,
                    box_size, centre, device="cuda") -> torch.Tensor:
    """(T, N, 3) positions of N particles with stable identity: uniform in
    the box at frame 0 from (seed, job), then x += 0.02 * swirl(x), the
    swirl (-r_x, 0.3, r_z) about ``centre`` in axis order (z, y, x)."""
    g = generator(seed, 6, job, device=device)
    size = torch.tensor(box_size, dtype=torch.float32, device=device)
    x = (torch.rand((n, 3), generator=g, device=device) * size
         + torch.tensor(box_lo, dtype=torch.float32, device=device))
    c = torch.tensor(centre, dtype=torch.float32, device=device)
    out = [x]
    for _ in range(frames - 1):
        r = out[-1] - c
        swirl = torch.stack([-r[:, 2], torch.full_like(r[:, 0], 0.3),
                             r[:, 0]], dim=-1)
        out.append(out[-1] + 0.02 * swirl)
    return torch.stack(out)
