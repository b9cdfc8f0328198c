"""Plain PyTorch reference of an LNST keyframe (Kim et al., arXiv
2005.00803): per-particle position offsets and log-density factors
optimized through a quadratic B-spline splat, the multi-view render and
the Gram loss of VGG-19 features; coarse octaves in grid space, folded
into the particles' densities; keyframes interpolated along particle
identity.

It imports nothing of the program. It is written from the algorithm as
the port states it (parent commit 7a3f9ef): ``nfs_tpu_torch/ops/splat.py``,
``ops/binsplat.py``, ``ops/interp.py`` and ``styler/particle.py``. The
program's binned splat is a configuration of the algorithm, not a speed
trick the reference may skip, so it is reproduced here as such: every
``rebin_every`` iterations each particle is anchored at its base cell
(``floor(p - 0.5)``, clamped to the padded grid), at most K particles a
cell keep a slot (in the order of a stable sort of the base cells, the
rest are left out of the splat until the next anchoring), and a particle
splats its 3 x 3 x 3 taps around the anchored cell at its current
position. K follows the program's stated rule (``_octave_ks``: the
occupancy probe, the K budget, even buckets, a margin of 2). The splat
itself is one ``index_add`` of every kept tap.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.tnst import Tnst, octave_shapes, render

PAD = 2
KCAND = 16


def bspline(u: torch.Tensor) -> torch.Tensor:
    au = u.abs()
    return torch.where(au < 0.5, 0.75 - au * au,
                       torch.where(au < 1.5, 0.5 * (1.5 - au) ** 2, 0.0))


def base_cells(p: torch.Tensor, shape) -> torch.Tensor:
    """(N, 3) base cells in padded coordinates, clamped so that the three
    taps stay inside the padded grid."""
    hi = torch.tensor([s + 2 * PAD - 3 for s in shape], device=p.device)
    return torch.clamp(torch.floor(p - 0.5).long() + PAD, min=0).minimum(hi)


def _flat(base: torch.Tensor, shape) -> torch.Tensor:
    ps = [s + 2 * PAD for s in shape]
    return (base[:, 0] * ps[1] + base[:, 1]) * ps[2] + base[:, 2]


def occupancy(p: torch.Tensor, shape) -> np.ndarray:
    """[most particles in one base cell, parked(1..16)], parked(k) the
    particles a capacity k leaves out."""
    n_cells = math.prod(s + 2 * PAD for s in shape)
    counts = torch.bincount(_flat(base_cells(p, shape), shape),
                            minlength=n_cells)
    parked = [int(torch.clamp(counts - k, min=0).sum())
              for k in range(1, KCAND + 1)]
    return np.array([int(counts.max())] + parked)


def capacity(stats: np.ndarray, shape, n: int, budget: Optional[float],
             max_slots: int, margin: int = 2) -> Optional[int]:
    """K of one octave: the most in a cell + 1 + margin, or the smallest
    K leaving out at most budget * n particles, rounded up to even (1 and
    2 stay); None where K slots a cell overrun ``max_slots``."""
    need = int(stats[0]) + 1 + margin
    budget_n = int(budget * n) if budget else 0
    if budget_n >= 1:
        ok = np.nonzero(stats[1:] <= budget_n)[0]
        if ok.size:
            need = min(need, int(ok[0]) + 1)
    k = need if need <= 2 else min(need + need % 2, 4096)
    if k < need:
        return None
    slots = math.prod(s + 2 * PAD for s in shape) * k
    return k if slots <= max_slots else None


def kept(p: torch.Tensor, shape, K: Optional[int]) -> torch.Tensor:
    """(N,) whether each particle holds one of its cell's K slots: rank
    within the cell by a stable sort of the base cells."""
    if K is None:
        return torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    flat = _flat(base_cells(p, shape), shape)
    key, order = torch.sort(flat, stable=True)
    ar = torch.arange(key.numel(), device=p.device)
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    rank = ar - torch.cummax(torch.where(start, ar, 0), dim=0).values
    out = torch.empty_like(start)
    out[order] = rank < K
    return out


def splat(p: torch.Tensor, dens: torch.Tensor, shape,
          base: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Quadratic B-spline splat of the kept particles at positions ``p``
    around their anchored base cells ``base``; taps off the grid drop."""
    n_cells = math.prod(shape)
    idx, val = [], []
    for off in itertools.product(range(3), repeat=3):
        w = dens
        flat = torch.zeros_like(base[:, 0])
        ok = keep
        for d in range(3):
            node = base[:, d] - PAD + off[d]
            w = w * bspline(node.to(torch.float32) - p[:, d])
            ok = ok & (node >= 0) & (node < shape[d])
            flat = flat * shape[d] + node.clamp(0, shape[d] - 1)
        idx.append(torch.where(ok, flat, n_cells))
        val.append(w)
    grid = torch.zeros(n_cells + 1, dtype=dens.dtype, device=dens.device)
    grid = grid.index_add(0, torch.cat(idx), torch.cat(val))
    return grid[:n_cells].view(shape)


def sample(g: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of g at (N, 3) index coordinates, the corners
    clamped to the grid."""
    lo = torch.floor(coords)
    fr = coords - lo
    lo = lo.long()
    out = 0.0
    for c in itertools.product((0, 1), repeat=3):
        w = 1.0
        idx = []
        for d in range(3):
            w = w * (fr[:, d] if c[d] else 1.0 - fr[:, d])
            idx.append((lo[:, d] + c[d]).clamp(0, g.shape[d] - 1))
        out = out + w * g[tuple(idx)]
    return out


def offset(dx: torch.Tensor, max_offset: float) -> torch.Tensor:
    return max_offset * torch.tanh(dx / max_offset)


class Lnst:
    """Keyframes of one particle configuration: ``style`` its dotted
    ``style_config``, ``grid`` the splat grid, ``vgg`` and ``style_image``
    what the program was given, ``seed`` the configuration seed (the view
    pool's)."""

    def __init__(self, style: Dict, grid: Sequence[int], vgg, style_image,
                 seed: int, device="cuda", precision: str = "program"):
        self.t = Tnst(style, vgg, style_image, seed, device, precision)
        self.g, self.grid = self.t.g, tuple(grid)

    def plan(self, x: torch.Tensor) -> List[Optional[int]]:
        """K of each octave from one occupancy probe of positions x."""
        g = self.g
        return [capacity(occupancy(x * (s[0] / self.grid[0]), s), s,
                         x.shape[0], g["particle.k_budget"],
                         g["particle.max_bin_slots"])
                for s in self._shapes()]

    def _shapes(self):
        return octave_shapes(self.grid, self.g["optim.octave_n"],
                             self.g["optim.octave_scale"])

    def _image_loss(self, d_grid, views, size):
        V = views.shape[0]
        imgs = render(d_grid[None].expand(V, *d_grid.shape), views[:, 0],
                      views[:, 1], self.g["render.transmit"], size)
        return self.t.image_losses(imgs[None])[0]

    def keyframe(self, x: torch.Tensor, dens: torch.Tensor,
                 schedule: np.ndarray, ks: List[Optional[int]],
                 init: Optional[Dict[str, torch.Tensor]] = None):
        """Optimize one keyframe: (param {'dx', 'ddens'}, (octaves, iters)
        losses). ``schedule`` (octaves, iters) pool indices; ``ks`` the
        bin capacity of each octave; ``init`` the warm start."""
        g = self.g
        mo = g["particle.max_offset"]
        param = ({"dx": torch.zeros_like(x),
                  "ddens": torch.zeros_like(dens)} if init is None
                 else {k: v.clone() for k, v in init.items()})
        shapes = self._shapes()
        losses = []
        for o, shape in enumerate(shapes):
            scale = shape[0] / self.grid[0]
            size = tuple(max(g["render.min_render_size"],
                             int(round(s * scale / 8)) * 8)
                         for s in g["render.render_size"])
            views = [self.t.pool[int(j)] for j in schedule[o]]
            if o < len(shapes) - 1:     # grid space
                with torch.no_grad():
                    p = (x + offset(param["dx"], mo)) * scale
                    d = dens * torch.exp(param["ddens"])
                    base = splat(p, d, shape, base_cells(p, shape),
                                 kept(p, shape, ks[o])) * scale ** 2
                fld, ls = self._adam(
                    {"g": torch.zeros_like(base)},
                    lambda q, i: self._image_loss(
                        base * torch.exp(q["g"]), views[i], size))
                param["ddens"] = param["ddens"] + sample(fld["g"], p)
            else:
                param, ls = self._particles(param, x, dens, shape, scale,
                                            size, views, ks[o])
            losses.append(ls)
        return param, torch.stack(losses)

    def _particles(self, param, x, dens, shape, scale, size, views, K):
        g = self.g
        mo = g["particle.max_offset"]
        chunk = max(1, g["particle.rebin_every"])
        n_dx = float(x.numel())
        anchor = {}

        def loss(q, i):
            if i % chunk == 0 or K is None:     # K None: the flat splat
                with torch.no_grad():
                    p0 = (x + offset(q["dx"], mo)) * scale
                    anchor["base"] = base_cells(p0, shape)
                    anchor["keep"] = kept(p0, shape, K)
            p = (x + offset(q["dx"], mo)) * scale
            d = splat(p, dens * torch.exp(q["ddens"]), shape,
                      anchor["base"], anchor["keep"]) * scale ** 2
            return (self._image_loss(d, views[i], size)
                    + 1e-3 * torch.sum(q["dx"] ** 2) / n_dx)

        return self._adam(param, loss)

    def _adam(self, param, loss_fn):
        g = self.g
        lr, b1, b2, eps = g["optim.lr"], g["optim.b1"], g["optim.b2"], 1e-8
        mu = {k: torch.zeros_like(v) for k, v in param.items()}
        nu = {k: torch.zeros_like(v) for k, v in param.items()}
        losses = []
        for i in range(g["optim.iters"]):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in param.items()}
            loss = loss_fn(leaves, i)
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            losses.append(loss.detach())
            c = np.float32(i + 1)
            bc1 = float(np.float32(1) - np.float32(b1) ** c)
            bc2 = float(np.float32(1) - np.float32(b2) ** c)
            for k in param:
                mu[k] = (1 - b1) * grads[k] + b1 * mu[k]
                nu[k] = (1 - b2) * grads[k] ** 2 + b2 * nu[k]
                param[k] = (param[k] - lr * ((mu[k] / bc1) / (
                    torch.sqrt(nu[k] / bc2) + eps))).detach()
        return param, torch.stack(losses)

    def apply(self, x, dens, param):
        """(positions, densities) of a particle set under ``param``."""
        mo = self.g["particle.max_offset"]
        return (x + offset(param["dx"], mo),
                dens * torch.exp(param["ddens"]))

    def recover(self, x, dens, x_out, dens_out):
        """The param that ``apply`` maps (x, dens) to (x_out, dens_out):
        how a keyframe's output warm-starts the next one's check."""
        mo = self.g["particle.max_offset"]
        off = torch.clamp((x_out - x) / mo, -1 + 1e-6, 1 - 1e-6)
        return {"dx": mo * torch.atanh(off),
                "ddens": torch.log(dens_out / dens)}

    @staticmethod
    def lerp(p0, p1, alpha: float):
        return {k: (1 - alpha) * p0[k] + alpha * p1[k] for k in p0}
