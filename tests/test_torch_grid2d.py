"""nfs_tpu_torch's grid styler on 2D grids (BASELINE configs #1 and #2 at
a small size), with a trained transfer function, and on 3D with the
gather rotation, against the JAX package on the CPU.

Both sides get the same numpy-made densities, velocities and style
image, the JAX package's VGG weights carried across with
``params_from_numpy``, and f32 features. A 2D grid is its own image, so
no view draw is involved; the 3D case uses ``view_pool=1`` (every draw
is pool entry 0 whatever the PRNG).

The style weight is 1000, so the gradients stand well above Adam's eps
(1e-8). At weight 1 the random VGG's style gradients are ~1e-8 and
Adam's normalised step turns f32 rounding into sign flips of whole
+-lr steps: the 2D window sequence then drifts apart by 3e-4 after
frame 1 and 0.045 after frame 2 in BOTH directions of rounding, the
same amplification ``test_torch_styler.py`` measures in 3D (9e-5 after
frame 1), while at weight 1000 the two packages agree to ~1e-6 on every
frame.

Tolerances, as the 3D styler parity tests (``test_torch_styler.py``):
per-iteration losses, the final one included, within 1e-4 relative (the
same f32 VGG, Gram, render and advection sums in another order; measured
<= 4e-7); fields within 1e-3 (2 * lr * steps bounds any divergence at
0.16; measured <= 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params
from nfs_tpu.styler.grid import GridStyler as JaxGridStyler
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.features.vgg import params_from_numpy
from nfs_tpu_torch.styler.grid import GridStyler

torch.set_num_threads(2)

SHAPE = (24, 18)
OVER = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.view_pool": 1,
    "render.n_views": 2,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1", "relu2_1"),
    "loss.style_layer_weights": (1.0, 1.0),
    "loss.w_style": 1000.0,
    "loss.w_tv": 0.1,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.02,
    "optim.log_every": 1,
}
LOSS_RTOL = 1e-4
FIELD_ATOL = 1e-3


@pytest.fixture(scope="module")
def vgg_np():
    return jax.tree.map(np.asarray, init_vgg_params(0))


def _stylers(vgg_np, **over):
    kw = dict(OVER, **over)
    style = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)
    js = JaxGridStyler(jax_replace(JaxStyleConfig(), **kw),
                       vgg_params=jax.tree.map(jnp.asarray, vgg_np),
                       style_image=style)
    ts = GridStyler(replace(StyleConfig(), **kw),
                    vgg_params=params_from_numpy(vgg_np),
                    style_image=style, device="cpu")
    return js, ts


def _density(t=0, shape=SHAPE):
    g = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    noise = np.random.default_rng(10 + t).random(shape)
    d = 1.5 * np.exp(-4 * ((g[0] - 0.1 * t) ** 2
                           + sum(x ** 2 for x in g[1:])))
    return (d * (1.0 + 0.2 * noise)).astype(np.float32)


def _velocities(n, seed=20, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return (0.7 * rng.standard_normal((n,) + shape + (len(shape),))
            ).astype(np.float32)


def _losses(info):
    return np.concatenate([np.asarray(l) for l in info["octave_losses"]])


@pytest.mark.parametrize("parameterization", ["density", "velocity"])
def test_2d_frame_matches_jax(vgg_np, parameterization):
    """Config #1's path: a single 2D frame through render2d."""
    js, ts = _stylers(vgg_np, **{"optim.parameterization": parameterization})
    d = _density()
    jd, jp, jinfo = js.stylize_frame(d, key=jax.random.PRNGKey(0))
    td, tp, tinfo = ts.stylize_frame(d)
    np.testing.assert_allclose(_losses(tinfo), _losses(jinfo),
                               rtol=LOSS_RTOL)
    assert td.shape == SHAPE
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= FIELD_ATOL
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= FIELD_ATOL


def test_2d_window_sequence_matches_jax(vgg_np):
    """Config #2's path: a 2D sequence with W = 1 window transport and
    the recursive warm start."""
    js, ts = _stylers(vgg_np, **{"optim.window": 1})
    ds = np.stack([_density(t) for t in range(3)])
    vs = _velocities(3)
    jl, tl = [], []
    jouts = [(np.asarray(d), np.asarray(p)) for _, d, p in
             js.stylize_sequence(ds, vs, fused=0,
                                 callback=lambda n, l, octave: jl.append(l))]
    touts = [(d.numpy(), p.numpy()) for _, d, p in
             ts.stylize_sequence(ds, vs, fused=0,
                                 callback=lambda n, l, octave: tl.append(l))]
    assert len(tl) == len(jl) == 3 * 2 * 3
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    for (td, tp), (jd, jp) in zip(touts, jouts):
        assert td.shape == jd.shape == SHAPE
        assert np.abs(td - jd).max() <= FIELD_ATOL
        assert np.abs(tp - jp).max() <= FIELD_ATOL


@pytest.mark.parametrize("window", [0, 1])
def test_train_transfer_matches_jax(vgg_np, window):
    """render.train_transfer: the {'field', 'tf'} param, its nodes
    trained with the field; a 2D frame, then a 2-frame window sequence
    whose carry is the dict."""
    js, ts = _stylers(vgg_np, **{"render.transfer_fn": "fire",
                                 "render.train_transfer": True,
                                 "render.tf_max_density": 1.5,
                                 "optim.window": window})
    if window == 0:
        d = _density()
        jd, jp, jinfo = js.stylize_frame(d, key=jax.random.PRNGKey(0))
        td, tp, tinfo = ts.stylize_frame(d)
        np.testing.assert_allclose(_losses(tinfo), _losses(jinfo),
                                   rtol=LOSS_RTOL)
        outs = [(td, tp, jd, jp)]
        np.testing.assert_allclose(tinfo["tf_nodes"].numpy(),
                                   np.asarray(jinfo["tf_nodes"]),
                                   atol=FIELD_ATOL)
    else:
        ds = np.stack([_density(t) for t in range(2)])
        vs = _velocities(2)
        # each JAX yield is read at once: the next frame's scan donates
        # the carry's buffers
        jouts = [(np.asarray(jd), jax.tree.map(np.asarray, jp))
                 for _, jd, jp in js.stylize_sequence(ds, vs, fused=0)]
        outs = [(td, tp, jd, jp) for (_, td, tp), (jd, jp) in zip(
            ts.stylize_sequence(ds, vs, fused=0), jouts)]
    for td, tp, jd, jp in outs:
        assert sorted(tp) == ["field", "tf"]
        assert np.abs(td.numpy() - np.asarray(jd)).max() <= FIELD_ATOL
        for k in ("field", "tf"):
            assert np.abs(tp[k].numpy()
                          - np.asarray(jp[k])).max() <= FIELD_ATOL
    # the nodes moved away from the colormap
    assert np.abs(outs[-1][1]["tf"].numpy()
                  - ts.tf_nodes.numpy()).max() > 1e-4


def test_gather_rotation_frame_matches_jax(vgg_np):
    """A 3D frame rendered through rotation='gather' and a transfer
    function."""
    js, ts = _stylers(vgg_np, **{"render.rotation": "gather",
                                 "render.transfer_fn": "ice",
                                 "optim.iters": 2})
    d = _density(shape=(10, 8, 10))
    jd, jp, jinfo = js.stylize_frame(d, key=jax.random.PRNGKey(0))
    td, tp, tinfo = ts.stylize_frame(d)
    np.testing.assert_allclose(_losses(tinfo), _losses(jinfo),
                               rtol=LOSS_RTOL)
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= FIELD_ATOL
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= FIELD_ATOL
