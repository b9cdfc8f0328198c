"""Plain PyTorch reference of a TNST grid frame (Kim et al., arXiv
1905.07442): the density parameterization, the Gaussian-window transport
loss, multi-view Beer-Lambert renders through the three-shear rotation,
the Gram loss of VGG-19 features, octave Adam, and the MacCormack warm
start of a sequence's next frame.

It imports nothing of the program. It is written from the algorithm, as
the port states it (parent commit 7a3f9ef): the formulas follow
``nfs_tpu_torch/render/raymarch.py``, ``ops/shear.py``, ``ops/resize.py``,
``ops/advect.py`` and ``advect_kernels.py`` (``advect_fwd_plain``),
``features/vgg.py``, ``features/losses.py``, ``styler/octave.py`` and
``styler/grid.py``, and :func:`view_pool` is a frozen copy of
``render/camera.py`` ``poisson_view_pool`` (Bridson dart throwing; the
program derives its pool from the seed, so the reference derives it
again). Advection is one differentiable gather of eight trilinear corners
(autograd gives the field gradient), no kernel.

``precision``: ``"program"`` computes as the configuration states (float32
renders with TF32 off, bfloat16 features, a float32 Gram). The controls
sit one precision below: ``"fp8"`` rounds every convolution's input and
weights to float8 (e4m3) before the bfloat16 convolution; ``"tf32"``
lets the float32 shears and Gram products run in TF32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

F32 = np.float32

# ----------------------------------------------------------------------
# view pool (frozen copy of render/camera.py)
# ----------------------------------------------------------------------


def _bridson(n, lo, hi, r, rng, k):
    cell = r / math.sqrt(2.0)
    gw = int(np.ceil((hi[0] - lo[0]) / cell)) + 1
    gh = int(np.ceil((hi[1] - lo[1]) / cell)) + 1
    grid = -np.ones((gw, gh), dtype=np.int64)
    pts, active = [], []

    def gidx(p):
        return (int((p[0] - lo[0]) / cell), int((p[1] - lo[1]) / cell))

    def fits(p):
        gx, gy = gidx(p)
        for xx in range(max(gx - 2, 0), min(gx + 3, gw)):
            for yy in range(max(gy - 2, 0), min(gy + 3, gh)):
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


def _poisson_disk(n, lo, hi, rng, k=30):
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    ext = np.maximum(hi - lo, 0.0)
    if ext[0] * ext[1] <= 0.0:
        return (lo[None, :] + rng.random((n, 2)) * ext[None, :]).astype(F32)
    r = math.sqrt(ext[0] * ext[1] / (2.0 * math.sqrt(3.0) * n))
    for _ in range(8):
        pts = _bridson(n, lo, hi, r, rng, k)
        if pts.shape[0] >= n:
            return pts[:n].astype(F32)
        r *= 0.8
    extra = lo[None, :] + rng.random((n - pts.shape[0], 2)) * ext[None, :]
    return np.concatenate([pts, extra], axis=0).astype(F32)


def view_pool(pool_size: int, n_views: int, theta_range, phi_range,
              seed: int) -> np.ndarray:
    """(pool_size, n_views, 2) (theta, phi) radians; ranges in degrees."""
    rng = np.random.default_rng(seed)
    lo = (math.radians(theta_range[0]), math.radians(phi_range[0]))
    hi = (math.radians(theta_range[1]), math.radians(phi_range[1]))
    return np.stack([_poisson_disk(n_views, lo, hi, rng)
                     for _ in range(pool_size)]).astype(F32)


# ----------------------------------------------------------------------
# resize: jax.image.resize 'linear', antialiased
# ----------------------------------------------------------------------


def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) triangle-kernel weights, widened by 1/scale when
    shrinking, columns normalised, samples outside the input zeroed."""
    inv = F32(n_in / n_out)
    width = max(inv, F32(1.0))
    sample = (np.arange(n_out, dtype=F32) + F32(0.5)) * inv - F32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=F32)[:, None]) / width
    w = np.maximum(F32(0.0), F32(1.0) - np.abs(x)).astype(F32)
    total = w.sum(axis=0, keepdims=True, dtype=F32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(F32).eps),
                 w / np.where(total != 0, total, F32(1.0)), F32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, F32(0.0)).astype(F32)


def resize_axes(x: torch.Tensor, axes, sizes) -> torch.Tensor:
    for ax, n in zip(axes, sizes):
        if x.shape[ax] == n:
            continue
        w = torch.from_numpy(weight_matrix(x.shape[ax], n)).to(x.device)
        x = torch.tensordot(x, w, dims=([ax], [0])).movedim(-1, ax)
    return x


def resize(field: torch.Tensor, shape, is_velocity: bool = False):
    out = resize_axes(field, range(len(shape)), shape)
    if is_velocity:
        out = out * torch.tensor([shape[i] / field.shape[i]
                                  for i in range(len(shape))],
                                 dtype=out.dtype, device=out.device)
    return out


def octave_shapes(shape, octave_n: int, scale: float):
    out = []
    for o in range(octave_n - 1):
        f = scale ** (octave_n - 1 - o)
        out.append(tuple(max(1, int(round(s / f))) for s in shape))
    return out + [tuple(shape)]


def render_size(octave_shape, full_shape, size, min_size):
    f = max(octave_shape[0] / full_shape[0], octave_shape[-1] / full_shape[-1])
    return tuple(max(min_size, int(round(s * f / 8)) * 8) for s in size)


# ----------------------------------------------------------------------
# render
# ----------------------------------------------------------------------


def _shear(vol: torch.Tensor, move: int, drive: int,
           slope: torch.Tensor) -> torch.Tensor:
    """Pull-back shear of (N, D, H, W) volumes along axis ``move``, offset
    slope * (x_drive - centre), linear interpolation, zero outside."""
    n, size, dsize = vol.shape[0], vol.shape[1 + move], vol.shape[1 + drive]
    b = torch.arange(dsize, dtype=torch.float32, device=vol.device)
    s = slope[:, None] * (b - (dsize - 1) / 2.0)                  # (N, B)
    i = torch.arange(size, dtype=torch.float32, device=vol.device)
    mat = torch.clamp(1.0 - ((i[:, None] - s[..., None, None])
                             - i[None, :]).abs(), min=0.0)     # (N,B,S,S)
    other = 3 - move - drive
    perm = (0, 1 + drive, 1 + move, 1 + other)
    v = vol.permute(perm)
    out = torch.bmm(mat.reshape(n * dsize, size, size),
                    v.reshape(n * dsize, size, v.shape[-1]))
    out = out.view(n, dsize, size, v.shape[-1])
    inv = [0] * 4
    for new, old in enumerate(perm):
        inv[old] = new
    return out.permute(inv)


def rotate(vols: torch.Tensor, theta: torch.Tensor,
           phi: torch.Tensor) -> torch.Tensor:
    """Azimuth theta about y (the (z, x) plane), then elevation phi about
    x (the (z, y) plane), each three shears."""
    for (u, v), ang in (((0, 2), theta), ((0, 1), phi)):
        a, b = -torch.tan(ang / 2.0), torch.sin(ang)
        vols = _shear(vols, u, v, a)
        vols = _shear(vols, v, u, b)
        vols = _shear(vols, u, v, a)
    return vols


def _relu_half(x):
    """max(x, 0) whose gradient at 0 is 1/2, as jnp.maximum's."""
    return 0.5 * (x + x.abs())


def render(vols: torch.Tensor, theta: torch.Tensor, phi: torch.Tensor,
           transmit: float, out_size) -> torch.Tensor:
    """(N, D, H, W) volumes, one view each -> (N, h, w, 3) images."""
    rho = _relu_half(rotate(vols, theta, phi))
    trans = torch.exp(-transmit * (torch.cumsum(rho, dim=1) - rho))
    img = torch.sum(transmit * rho * trans, dim=1)
    img = resize_axes(img, (1, 2), out_size)
    return img[..., None].expand(*img.shape, 3)


# ----------------------------------------------------------------------
# VGG-19 features and the Gram loss
# ----------------------------------------------------------------------

VGG = (("conv1_1", 64), ("conv1_2", 64), "pool", ("conv2_1", 128),
       ("conv2_2", 128), "pool", ("conv3_1", 256), ("conv3_2", 256),
       ("conv3_3", 256), ("conv3_4", 256), "pool", ("conv4_1", 512),
       ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), "pool",
       ("conv5_1", 512))
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 in the forward; the gradient passes
    through the rounding (a cast to float8 carries none)."""
    return x + (x.to(torch.float8_e4m3fn).to(x.dtype) - x).detach()


def features(params, images: torch.Tensor, layers: Sequence[str],
             dtype=None, precision: str = "program"):
    """NHWC images in [0, 1] -> {relu layer: NHWC activations}."""
    mean = torch.tensor(MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(STD, dtype=images.dtype, device=images.device)
    x = ((images - mean) / std).permute(0, 3, 1, 2)
    if dtype is not None:
        x = x.to(dtype)
    deepest = max(i for i, e in enumerate(VGG)
                  if e != "pool" and f"relu{e[0][4:]}" in layers)
    out = {}
    for i, e in enumerate(VGG[:deepest + 1]):
        if e == "pool":
            x = F.avg_pool2d(x, 2)
            continue
        w = params[e[0]]["w"].to(x.dtype)
        b = params[e[0]]["b"].to(x.dtype)
        if precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        x = torch.relu(F.conv2d(x, w, b, padding=1))
        name = f"relu{e[0][4:]}"
        if name in layers:
            out[name] = x.permute(0, 2, 3, 1)
    return out


def gram(feat: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., C, C), f32, divided by H*W*C."""
    h, w, c = feat.shape[-3:]
    f = feat.movedim(-1, -3).reshape(*feat.shape[:-3], c, h * w)
    f = f.to(torch.float32)
    return torch.matmul(f, f.transpose(-1, -2)) / float(h * w * c)


@contextlib.contextmanager
def tf32(on: bool):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


# ----------------------------------------------------------------------
# advection: clamped backtrace, eight trilinear corners
# ----------------------------------------------------------------------


def advect(field: torch.Tensor, vel: torch.Tensor,
           max_disp: float) -> torch.Tensor:
    """out(x) = field(clip(x - clip(vel(x), +-max_disp), grid)), trilinear,
    corners outside the grid reading 0; differentiable in ``field``."""
    shape = field.shape
    disp = vel.clamp(-max_disp, max_disp)
    s, base = [], []
    for a, n in enumerate(shape):
        view = [1, 1, 1]
        view[a] = n
        idx = torch.arange(n, dtype=torch.float32,
                           device=field.device).view(view)
        s.append((idx - disp[..., a]).clamp(0.0, n - 1))
        base.append(torch.floor(s[-1]))
    flat = field.reshape(-1)
    out = torch.zeros_like(field)
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                w, lin = 1.0, 0
                for a, (c, n) in enumerate(zip((cz, cy, cx), shape)):
                    ci = base[a] + c
                    ok = (ci >= 0) & (ci <= n - 1)
                    w = w * torch.where(
                        ok, torch.clamp(1.0 - (s[a] - ci).abs(), min=0.0),
                        0.0)
                    lin = lin * n + ci.clamp(0, n - 1).long()
                out = out + w * flat[lin]
    return out


def maccormack(field: torch.Tensor, vel: torch.Tensor,
               max_disp: float) -> torch.Tensor:
    """BFECC with min-max limiting over the displacement neighbourhood."""
    fwd = advect(field, vel, max_disp)
    bwd = advect(fwd, -vel, max_disp)
    k = 2 * (int(math.ceil(max_disp)) + 1) + 1
    x = field[None, None]
    maxs = F.max_pool3d(x, k, stride=1, padding=k // 2)[0, 0]
    mins = -F.max_pool3d(-x, k, stride=1, padding=k // 2)[0, 0]
    out = fwd + 0.5 * (field - bwd)
    return torch.minimum(torch.maximum(out, mins), maxs)


# ----------------------------------------------------------------------
# the frame
# ----------------------------------------------------------------------


class Tnst:
    """The style loss and the octave sweep of one configuration.

    ``style``: the configuration's ``style_config`` mapping (dotted keys);
    ``vgg``: the weights the program was given; ``style_image`` (H, W, 3);
    ``seed``: the configuration seed, from which the view pool is drawn.
    """

    def __init__(self, style: Dict, vgg, style_image: np.ndarray, seed: int,
                 device="cuda", precision: str = "program"):
        g = {**DEFAULTS, **style}
        self.g, self.vgg, self.device = g, vgg, torch.device(device)
        self.precision = precision
        self.layers = tuple(g["loss.style_layers"])
        self.layer_w = tuple(g["loss.style_layer_weights"])
        self.dtype = (torch.bfloat16 if g["loss.features_dtype"] == "bfloat16"
                      else None)
        with torch.no_grad(), tf32(False):
            img = torch.as_tensor(style_image, dtype=torch.float32,
                                  device=self.device)[None]
            feats = features(vgg, img, self.layers,
                             precision="program")
            self.targets = {k: gram(v[0]) for k, v in feats.items()}
        self.pool = torch.from_numpy(view_pool(
            g["render.view_pool"], g["render.n_views"],
            (g["render.theta0"], g["render.theta1"]),
            (g["render.phi0"], g["render.phi1"]), seed)).to(self.device)

    def image_losses(self, imgs: torch.Tensor) -> torch.Tensor:
        """(B, V, h, w, 3) -> (B,) Gram losses, each a mean over its V."""
        B = imgs.shape[0]
        with tf32(self.precision == "tf32"):
            feats = features(self.vgg, imgs.reshape((-1,) + imgs.shape[2:]),
                             self.layers, self.dtype, self.precision)
            style = 0.0
            for layer, lw in zip(self.layers, self.layer_w):
                d = (gram(feats[layer]) - self.targets[layer]) ** 2
                style = style + lw * torch.mean(d.reshape(B, -1), dim=1)
        return self.g["loss.w_style"] * style

    def loss(self, d_star, vels, views, out_size) -> torch.Tensor:
        """Window loss of one frame's d*: ``vels`` (2W, ...) as the program
        takes them, ``views`` (2W+1, V, 2) one view set per position."""
        g = self.g
        W = g["optim.window"]
        md = g["optim.max_disp"]
        states = [None] * (2 * W + 1)
        states[W] = d_star
        d_j = d_star
        for j in range(1, W + 1):
            d_j = advect(d_j, vels[W + j - 1], md)
            states[W + j] = d_j
        d_j = d_star
        for j in range(1, W + 1):
            d_j = advect(d_j, -vels[W - j], md)
            states[W - j] = d_j
        P, V = len(states), views.shape[1]
        vols = torch.stack(states)[:, None].expand(P, V, *d_star.shape)
        with tf32(self.precision == "tf32"):
            imgs = render(vols.reshape(P * V, *d_star.shape),
                          views[..., 0].reshape(-1), views[..., 1].reshape(-1),
                          g["render.transmit"], out_size)
        losses = self.image_losses(imgs.view(P, V, *imgs.shape[1:]))
        j = torch.arange(-W, W + 1, dtype=torch.float32, device=d_star.device)
        w = torch.exp(-0.5 * (j / max(g["optim.window_sigma"], 1e-6)) ** 2)
        return torch.sum((w / torch.sum(w)) * losses)

    def frame(self, d: torch.Tensor, vels: torch.Tensor,
              schedule: np.ndarray, init: Optional[torch.Tensor] = None):
        """Stylize one frame: (d*, param, (octaves, iters) losses).
        ``schedule`` (octaves, iters, 2W+1) pool indices; ``init`` the warm
        start at full size."""
        g = self.g
        full = tuple(d.shape)
        shapes = octave_shapes(full, g["optim.octave_n"],
                               g["optim.octave_scale"])
        param = torch.zeros_like(d) if init is None else init
        losses = []
        for o, shape in enumerate(shapes):
            size = render_size(shape, full, g["render.render_size"],
                               g["render.min_render_size"])
            param = resize(param, shape)
            d_o = resize(d, shape)
            v_o = torch.stack([resize(v, shape, is_velocity=True)
                               for v in vels])
            param, ls = self._adam(param, lambda p, i: self.loss(
                d_o + p, v_o, self.pool[torch.as_tensor(schedule[o, i])],
                size), g["optim.iters"])
            losses.append(ls)
        return torch.clamp(d + param, min=0.0), param, torch.stack(losses)

    def _adam(self, param, loss_fn, iters):
        g = self.g
        lr, b1, b2, eps = g["optim.lr"], g["optim.b1"], g["optim.b2"], 1e-8
        mu = torch.zeros_like(param)
        nu = torch.zeros_like(param)
        losses = []
        for i in range(iters):
            p = param.detach().requires_grad_(True)
            loss = loss_fn(p, i)
            (grad,) = torch.autograd.grad(loss, [p])
            losses.append(loss.detach())
            mu = (1 - b1) * grad + b1 * mu
            nu = (1 - b2) * grad ** 2 + b2 * nu
            c = F32(i + 1)
            bc1 = float(F32(1) - F32(b1) ** c)
            bc2 = float(F32(1) - F32(b2) ** c)
            param = (param - lr * ((mu / bc1)
                                   / (torch.sqrt(nu / bc2) + eps))).detach()
        return param, torch.stack(losses)

    @torch.no_grad()
    def warm_start(self, prev_param: torch.Tensor,
                   prev_vel: torch.Tensor) -> torch.Tensor:
        return maccormack(prev_param, prev_vel, self.g["optim.max_disp"])


# the program's defaults for the keys a configuration file may leave out
# (nfs_tpu_torch/core/config.py at commit 7a3f9ef)
DEFAULTS = {
    "render.theta0": -10.0, "render.theta1": 10.0, "render.phi0": -5.0,
    "render.phi1": 5.0, "render.min_render_size": 64,
    "loss.w_style": 1.0, "optim.window_sigma": 1.0, "optim.b1": 0.9,
    "optim.b2": 0.999,
}
