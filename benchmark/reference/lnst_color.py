"""Plain PyTorch reference of an LNST job with colour transfer (Kim et
al., arXiv 2005.00803: "consistent color transfer from images"): per
particle a position offset, a log-density factor and a colour, optimized
at keyframes, each keyframe warm-started from the one before, the frames
between interpolated along particle identity.

It imports nothing of the program. It is written from the algorithm as
the port states it (parent commit d598f50): ``nfs_tpu_torch/ops/
binsplat.py`` ``splat_binned_color``, ``render/raymarch.py``
``render_views(color=)`` and ``styler/particle.py``. It builds on
:mod:`benchmark.reference.lnst` (the bin capacity and its anchoring, the
B-spline splat, the grid-space coarse octaves, Adam, the interpolation)
and :mod:`benchmark.reference.tnst` (the three-shear rotation, the
resize, VGG-19 and the Gram loss) and edits neither. Float32 throughout
with TF32 off, bfloat16 VGG features as the configuration states;
``precision`` gives the controls one precision below (``lnst.py``).

At the finest octave each kept particle splats five channels at its
taps, one ``index_add`` each: its density, its colour clipped to [0, 1]
(gradient 1/2 at a bound, as ``jnp.clip``'s) and 1. The colour grid is
the three colour channels over the last one plus 1e-6. The colour volume
is rotated with the density by the same shears, channel by channel, and
the image is the colour composited under the density's Beer-Lambert
weights, without the gamma curve.

Departures from the published description, all the port's:

- the coarse octaves run in grid space on the density alone (grey
  renders, a log-density field folded into the particles' factors), so
  colour is optimized at the finest octave only, where LNST optimizes
  every attribute at every scale;
- the colour grid is the weight-normalized average of the particles'
  colours (plus 1e-6 in the denominator), and the composite skips the
  gamma curve;
- a particle's taps stay anchored at the base cell of its chunk's first
  iteration, and at most K particles a cell take part (``lnst.py``);
- the loss network's weights are random (He-normal from the seed).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.lnst import Lnst, base_cells, kept, offset, splat
from benchmark.reference.tnst import _relu_half, resize_axes, rotate, tf32

EPS = 1e-6


def clip01(c: torch.Tensor) -> torch.Tensor:
    """clip(c, 0, 1) whose gradient is 1 inside, 1/2 at a bound and 0
    outside, as ``jnp.clip``'s."""
    slope = torch.where((c > 0) & (c < 1), 1.0,
                        torch.where((c == 0) | (c == 1), 0.5, 0.0))
    return c.clamp(0.0, 1.0).detach() + slope * (c - c.detach())


def render_color(d: torch.Tensor, color: torch.Tensor, theta: torch.Tensor,
                 phi: torch.Tensor, transmit: float,
                 out_size) -> torch.Tensor:
    """A (D, H, W) density and its (D, H, W, 3) colour under V views (theta,
    phi (V,)) -> (V, h, w, 3): the four volumes rotated by the same
    shears, the colour summed along depth under the weights transmit *
    rho * exp(-transmit * (density in front)), resized."""
    V = theta.shape[0]
    vols = torch.cat([d[None], color.movedim(-1, 0)])           # (4, D, H, W)
    vols = vols[:, None].expand(4, V, *d.shape).reshape(4 * V, *d.shape)
    rot = rotate(vols, theta.repeat(4), phi.repeat(4)).view(4, V, *d.shape)
    rho = _relu_half(rot[0])
    w = transmit * rho * torch.exp(-transmit * (torch.cumsum(rho, dim=1)
                                                - rho))
    img = torch.sum(w[..., None] * rot[1:].movedim(0, -1), dim=1)
    return resize_axes(img, (1, 2), out_size)


class LnstColor(Lnst):
    """Keyframes of one particle configuration with colour optimized; as
    :class:`Lnst`, every param also holds ``color`` (N, 3)."""

    @staticmethod
    def cold(x: torch.Tensor, dens: torch.Tensor,
             color: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The param a keyframe without a warm start begins from."""
        return {"dx": torch.zeros_like(x), "ddens": torch.zeros_like(dens),
                "color": color.clone()}

    def keyframe(self, x, dens, schedule, ks, init):
        """Optimize one keyframe from ``init`` (:meth:`cold`, or the
        previous keyframe's param): (param, (octaves, iters) losses).
        ``self.parked``: the most particles one rebin of the finest octave
        left out."""
        self.parked = 0
        with tf32(self.t.precision == "tf32"):
            return super().keyframe(x, dens, schedule, ks, init)

    def _particles(self, param, x, dens, shape, scale, size, views, K):
        g = self.g
        mo = g["particle.max_offset"]
        chunk = max(1, g["particle.rebin_every"])
        n_dx = float(x.numel())
        ones = torch.ones_like(dens)
        anchor = {}

        def loss(q, i):
            if i % chunk == 0 or K is None:     # K None: the flat splat
                with torch.no_grad():
                    p0 = (x + offset(q["dx"], mo)) * scale
                    anchor["base"] = base_cells(p0, shape)
                    anchor["keep"] = kept(p0, shape, K)
                    self.parked = max(self.parked,
                                      int((~anchor["keep"]).sum()))
            p = (x + offset(q["dx"], mo)) * scale
            c = clip01(q["color"])
            d, r, gr, b, w = (splat(p, a, shape, anchor["base"],
                                    anchor["keep"])
                              for a in (dens * torch.exp(q["ddens"]),
                                        c[:, 0], c[:, 1], c[:, 2], ones))
            color = torch.stack([r, gr, b], dim=-1) / (w[..., None] + EPS)
            imgs = render_color(d * scale ** 2, color, views[i][:, 0],
                                views[i][:, 1], g["render.transmit"], size)
            return (self.t.image_losses(imgs[None])[0]
                    + 1e-3 * torch.sum(q["dx"] ** 2) / n_dx)

        return self._adam(param, loss)

    def apply(self, x, dens, param):
        """(positions, densities, colours) of a particle set under
        ``param``: the colour is the param's own, unclipped."""
        return (*super().apply(x, dens, param), param["color"])

    def job(self, xs: torch.Tensor, dens: torch.Tensor, color: torch.Tensor,
            schedules: np.ndarray, stride: int, binned: bool = True):
        """A whole job: keyframes every ``stride`` frames of ``xs`` (T, N,
        3) and the last, keyframe 0 from :meth:`cold`, each later one
        warm-started from the one before; each frame's (x, dens, color)
        under its segment's interpolated param, and each keyframe's
        losses. ``schedules`` (keyframes, octaves, iters) pool indices.
        ``binned``: the bin plan is probed at the first keyframe and again
        at a keyframe after one that parked more than 4x the K budget;
        else every octave splats flat (K None)."""
        T, n = xs.shape[:2]
        kfs = list(range(0, T, stride))
        kfs = kfs if kfs[-1] == T - 1 else kfs + [T - 1]
        budget = self.g["particle.k_budget"]
        thresh = 4 * (int(budget * n) if budget else 0)
        n_oct = self.g["optim.octave_n"]
        params: Dict[int, Dict[str, torch.Tensor]] = {}
        losses: List[torch.Tensor] = []
        plan: List[Optional[int]] = [None] * n_oct
        prev = self.cold(xs[0], dens, color)
        for i, kf in enumerate(kfs):
            if binned and (i == 0 or self.parked > thresh):
                plan = self.plan(self.apply(xs[kf], dens, prev)[0])
            prev, ls = self.keyframe(xs[kf], dens, schedules[i], plan, prev)
            params[kf] = prev
            losses.append(ls)
        if len(kfs) == 1:
            return [self.apply(xs[0], dens, params[0])], losses
        frames = []
        for k0, k1 in zip(kfs[:-1], kfs[1:]):
            for t in range(k0, k1 + (k1 == kfs[-1])):
                alpha = (t - k0) / (k1 - k0)
                frames.append(self.apply(xs[t], dens, self.lerp(
                    params[k0], params[k1], alpha)))
        return frames, losses

