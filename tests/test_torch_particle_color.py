"""nfs_tpu_torch's particle colour (``particle.optimize_color``), 2D
particle grids and transfer-function renders of particles against the
JAX package on the CPU: ``stylize_frame`` in 3D and in 2D on the flat
splat (the colour grid by ``splat_normalized``) and on the binned one
(one 5-channel pass [density, colour(3), ones], normalized), and
``stylize_keyframes`` carrying the colour through the interpolation.

Both sides get the same numpy-made particles, colours (some exactly 0
and 1, the clip's ties) and style image, the JAX package's VGG weights
carried across with ``params_from_numpy``, f32 features, and
``view_pool=1`` (every view draw is pool entry 0 whatever the PRNG). The
style weight is 1000 so the gradients stand well above Adam's eps (see
``test_torch_grid2d.py``).

Tolerances, as ``test_torch_particle.py``: per-iteration losses, the
final one included, within 1e-4 relative (f32 VGG, Gram, splat and
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
from nfs_tpu_torch.styler import particle as TP

torch.set_num_threads(2)

OVER = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 1,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1", "relu2_1"),
    "loss.style_layer_weights": (1.0, 1.0),
    "loss.w_style": 1000.0,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.05,
    "optim.log_every": 1,
    "particle.optimize_density": True,
    "particle.optimize_color": True,
}
LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-4


@pytest.fixture(scope="module")
def vgg_np():
    return jax.tree.map(np.asarray, init_vgg_params(0))


def _stylers(vgg_np, grid, **over):
    kw = dict(OVER, **over)
    style = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)
    js = JP.ParticleStyler(jax_replace(JaxStyleConfig(), **kw),
                           grid_shape=grid,
                           vgg_params=jax.tree.map(jnp.asarray, vgg_np),
                           style_image=style)
    ts = TP.ParticleStyler(replace(StyleConfig(), **kw), grid_shape=grid,
                           vgg_params=params_from_numpy(vgg_np),
                           style_image=style, device="cpu")
    return js, ts


def _particles(grid, n=400, seed=0, t=0, color=True):
    rng = np.random.default_rng(seed)
    x = rng.random((n, len(grid))) * (np.array(grid) - 4) + 2
    x[:, 0] += 0.3 * t
    dens = (0.5 + rng.random(n)).astype(np.float32)
    col = None
    if color:
        col = rng.random((n, 3)).astype(np.float32)
        col[:20, 0] = 0.0
        col[20:40, 2] = 1.0
    return x.astype(np.float32), dens, col


def _run(styler, pset_cls, x, dens, col, wrap):
    losses = []
    styled, param, info = styler.stylize_frame(
        pset_cls(x=wrap(x), dens=wrap(dens),
                 color=None if col is None else wrap(col)),
        callback=lambda done, loss, octave: losses.append(loss))
    return styled, param, info, losses


def _check(j, t):
    (jst, jp, ji, jl), (tst, tp, ti, tl) = j, t
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
    assert (tst.color is None) == (jst.color is None)
    for a in ("x", "dens") + (("color",) if jst.color is not None else ()):
        np.testing.assert_allclose(getattr(tst, a).numpy(),
                                   np.asarray(getattr(jst, a)),
                                   atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("grid", [(12, 10, 12), (24, 20)],
                         ids=["3d", "2d"])
@pytest.mark.parametrize("impl", ["flat", "binned"])
@pytest.mark.parametrize("color", [True, False], ids=["rgb", "grey"])
def test_color_frame_matches_jax(vgg_np, grid, impl, color):
    """The colour attribute from the particles' colours (rgb) or from
    0.5 grey (no colour in the data)."""
    js, ts = _stylers(vgg_np, grid, **{"particle.splat_impl": impl})
    x, dens, col = _particles(grid, color=color)
    j = _run(js, JaxParticleSet, x, dens, col, jnp.asarray)
    t = _run(ts, ParticleSet, x, dens, col, lambda a: a)
    _check(j, t)
    # the colour was optimized
    start = col if color else np.full((len(x), 3), 0.5, np.float32)
    assert np.abs(t[1]["color"].numpy() - start).max() > 1e-3


@pytest.mark.parametrize("grid", [(12, 10, 12), (24, 20)],
                         ids=["3d", "2d"])
def test_transfer_function_frame_matches_jax(vgg_np, grid):
    """Density-only particles rendered through a transfer function."""
    js, ts = _stylers(vgg_np, grid, **{"particle.optimize_color": False,
                                       "render.transfer_fn": "fire"})
    x, dens, _ = _particles(grid, color=False)
    _check(_run(js, JaxParticleSet, x, dens, None, jnp.asarray),
           _run(ts, ParticleSet, x, dens, None, lambda a: a))


def test_color_keyframes_match_jax(vgg_np):
    """3 frames with stride 2: the colour of keyframes 0 and 2 and its
    interpolation at frame 1."""
    grid = (24, 20)
    js, ts = _stylers(vgg_np, grid, **{"particle.keyframe_stride": 2,
                                       "optim.iters": 2})
    frames = [_particles(grid, t=t) for t in range(3)]
    jout = [(t, jax.tree.map(np.asarray, (p.x, p.dens, p.color)))
            for t, p in js.stylize_keyframes(
                [JaxParticleSet(x=jnp.asarray(x), dens=jnp.asarray(d),
                                color=jnp.asarray(c))
                 for x, d, c in frames])]
    tout = list(ts.stylize_keyframes(
        [ParticleSet(x=x, dens=d, color=c) for x, d, c in frames]))
    assert [t for t, _ in tout] == [t for t, _ in jout] == [0, 1, 2]
    for (_, tp), (_, jp) in zip(tout, jout):
        for got, want in zip((tp.x, tp.dens, tp.color), jp):
            np.testing.assert_allclose(got.numpy(), want, atol=PARAM_ATOL,
                                       rtol=0)
