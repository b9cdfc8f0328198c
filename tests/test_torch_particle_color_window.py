"""nfs_tpu_torch's 3D B-spline particle colour with ``splat_impl='auto'``
against the JAX package on the CPU: the configuration lnst3d.color runs.

On this route the port's colour pass is ``splat_binned_color_window``
(``BinColorWindow``: K4c/K5c on a card, their plain twins on the CPU);
the JAX package's 'auto' takes its generic XLA window off a TPU. Both
sides run ``stylize_frame`` on a 3D grid, and ``stylize_keyframes`` with
each keyframe warm-started from the last and the colour interpolated
between them. Every case also asserts that the port took the window
route: the generic pass (``splat_binned_color`` and its body
``ops.binsplat._splat_binned``) raises if called, and the twins'
forward and backward each run once an iteration.

Both sides get the same numpy-made particles, colours (some exactly 0
and 1, the clip's ties, and some past them) and style image, the JAX
package's VGG weights carried across with ``params_from_numpy``, f32
features, and ``view_pool=1`` (every view draw is pool entry 0 whatever
the PRNG).

The style weight is 1e4, so the gradients stand well above Adam's eps
(1e-8). At 1000, as ``test_torch_particle_color.py`` has it, some
particles' position gradients in keyframe 2's fine octave are ~1e-7,
ten eps, where Adam's first step lr * g / (|g| + eps) turns f32 rounding
of g (the warm start carries keyframe 0's last bits in) into moves of
~1e-4: measured on the CPU, keyframe 2's positions then drift from the
JAX package's by up to 2.2e-4 on this route and 1.6e-4 on the port's
generic pass (``splat_impl='binned'``), the same amplification on both,
while the two routes' gradients agree to 2.4e-7. At 1e4 the drift is
7.6e-6 on this route and 1.9e-6 on the generic pass.

Tolerances, as ``test_torch_particle_color.py``: per-iteration losses,
the final one included, within 1e-4 relative (f32 VGG, Gram, splat and
render sums in another order); the final attributes and particles within
2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.core.pytrees import ParticleSet as JaxParticleSet
from nfs_tpu.features.vgg import init_vgg_params
from nfs_tpu.styler import particle as JP
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.features.vgg import params_from_numpy
from nfs_tpu_torch.ops import binsplat as TB
from nfs_tpu_torch.ops import binsplat_kernels as BK
from nfs_tpu_torch.styler import particle as TP

torch.set_num_threads(2)

GRID = (12, 10, 12)
OVER = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 1,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1", "relu2_1"),
    "loss.style_layer_weights": (1.0, 1.0),
    "loss.w_style": 1e4,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.05,
    "optim.log_every": 1,
    "particle.kernel": "bspline",
    "particle.splat_impl": "auto",
    "particle.optimize_density": True,
    "particle.optimize_color": True,
}
LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-4


@pytest.fixture(scope="module")
def vgg_np():
    return jax.tree.map(np.asarray, init_vgg_params(0))


@pytest.fixture
def window_calls(monkeypatch):
    """The calls of the port's colour twins; the generic colour pass
    raises if the port takes it."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    def refused(*args, **kwargs):
        raise AssertionError("the generic colour pass ran on the window "
                             "route")

    monkeypatch.setattr(BK, "window_color_fwd_plain", counted(
        "fwd", BK.window_color_fwd_plain))
    monkeypatch.setattr(BK, "window_color_bwd_plain", counted(
        "bwd", BK.window_color_bwd_plain))
    monkeypatch.setattr(TB, "_splat_binned", refused)
    monkeypatch.setattr(TP, "splat_binned_color", refused)
    return calls


def _stylers(vgg_np, **over):
    kw = dict(OVER, **over)
    style = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)
    js = JP.ParticleStyler(jax_replace(JaxStyleConfig(), **kw),
                           grid_shape=GRID,
                           vgg_params=jax.tree.map(jnp.asarray, vgg_np),
                           style_image=style)
    ts = TP.ParticleStyler(replace(StyleConfig(), **kw), grid_shape=GRID,
                           vgg_params=params_from_numpy(vgg_np),
                           style_image=style, device="cpu")
    assert TP._uses_window(ts.cfg.particle, GRID)
    return js, ts


def _particles(n=400, seed=0, t=0):
    """Particles over the grid; colours from -0.1 to 1.1, with 20 of the
    first channel tied at 0 and 20 of the third at 1."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)) * (np.array(GRID) - 4) + 2
    x[:, 0] += 0.3 * t
    dens = (0.5 + rng.random(n)).astype(np.float32)
    col = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    col[:20, 0] = 0.0
    col[20:40, 2] = 1.0
    return x.astype(np.float32), dens, col


def _iters(styler, n_keyframes=1):
    o = styler.cfg.optim
    return n_keyframes * o.octave_n * o.iters


def test_color_frame_on_the_window_route_matches_jax(vgg_np, window_calls):
    js, ts = _stylers(vgg_np)
    x, dens, col = _particles()
    jl, tl = [], []
    jst, jp, ji = js.stylize_frame(
        JaxParticleSet(x=jnp.asarray(x), dens=jnp.asarray(dens),
                       color=jnp.asarray(col)),
        callback=lambda done, loss, octave: jl.append(loss))
    tst, tp, ti = ts.stylize_frame(
        ParticleSet(x=x, dens=dens, color=col),
        callback=lambda done, loss, octave: tl.append(loss))
    assert window_calls == {"fwd": _iters(ts), "bwd": _iters(ts)}
    assert sorted(jp) == sorted(tp)
    assert ti["octave_overflow"] == ji["octave_overflow"]
    assert len(tl) == len(jl)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        torch.cat(ti["octave_losses"]).numpy(),
        np.concatenate([np.asarray(l) for l in ji["octave_losses"]]),
        rtol=LOSS_RTOL)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=PARAM_ATOL, rtol=0)
    for a in ("x", "dens", "color"):
        np.testing.assert_allclose(getattr(tst, a).numpy(),
                                   np.asarray(getattr(jst, a)),
                                   atol=PARAM_ATOL, rtol=0)
    # the colour was optimized, ties included
    assert np.abs(tp["color"].numpy() - np.clip(col, 0, 1)).max() > 1e-3


def test_color_keyframes_on_the_window_route_match_jax(vgg_np,
                                                       window_calls):
    """3 frames with stride 2: keyframe 2 warm-started from keyframe 0,
    and frame 1's colour interpolated between them."""
    js, ts = _stylers(vgg_np, **{"particle.keyframe_stride": 2,
                                 "optim.iters": 2})
    frames = [_particles(t=t) for t in range(3)]
    jout = [(t, jax.tree.map(np.asarray, (p.x, p.dens, p.color)))
            for t, p in js.stylize_keyframes(
                [JaxParticleSet(x=jnp.asarray(x), dens=jnp.asarray(d),
                                color=jnp.asarray(c))
                 for x, d, c in frames])]
    tout = list(ts.stylize_keyframes(
        [ParticleSet(x=x, dens=d, color=c) for x, d, c in frames]))
    assert window_calls == {"fwd": _iters(ts, 2), "bwd": _iters(ts, 2)}
    assert [t for t, _ in tout] == [t for t, _ in jout] == [0, 1, 2]
    for (_, tp), (_, jp) in zip(tout, jout):
        for got, want in zip((tp.x, tp.dens, tp.color), jp):
            np.testing.assert_allclose(got.numpy(), want, atol=PARAM_ATOL,
                                       rtol=0)
    assert sorted(ts.last_keyframe_infos) == sorted(js.last_keyframe_infos)
    for kf, info in js.last_keyframe_infos.items():
        np.testing.assert_allclose(
            torch.cat(ts.last_keyframe_infos[kf]["octave_losses"]).numpy(),
            np.concatenate([np.asarray(l) for l in info["octave_losses"]]),
            rtol=LOSS_RTOL)
