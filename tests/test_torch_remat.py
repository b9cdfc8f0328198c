"""Per-view rematerialization (``loss.remat_views``) of nfs_tpu_torch's
GridStyler: the port's remat against the JAX package's remat, W=0 and
W=1, on a 3D 16x12x16 frame with 2 views at 32^2; and the port's remat
against the port without it, in loss and gradient.

Both packages get the same numpy-made density, velocities and style
image, the JAX package's VGG weights carried across, and the same view
draws: ``view_pool=1`` (every draw is pool entry 0) for W=0, and for W=1
a 4-entry pool with JAX's per-iteration indices replayed through
``view_schedule``.
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

SHAPE = (16, 12, 16)
OVER = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 1,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1", "relu2_1"),
    "loss.style_layer_weights": (1.0, 1.0),
    "loss.remat_views": True,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 2,
    "optim.lr": 0.02,
    "optim.log_every": 1,
}


@pytest.fixture(scope="module")
def vgg_np():
    return jax.tree.map(np.asarray, init_vgg_params(0))


def _inputs():
    rng = np.random.default_rng(8)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in SHAPE],
                          indexing="ij")
    d = (2.0 * np.exp(-4 * (z ** 2 + y ** 2 + x ** 2))
         * (1.0 + 0.2 * rng.random(SHAPE))).astype(np.float32)
    vels = (0.7 * rng.standard_normal((2,) + SHAPE + (3,))).astype(
        np.float32)
    style = rng.random((32, 32, 3), dtype=np.float32)
    return d, vels, style


def _torch_styler(vgg_np, style, **over):
    return GridStyler(replace(StyleConfig(), **dict(OVER, **over)),
                      vgg_params=params_from_numpy(vgg_np),
                      style_image=style, device="cpu")


def _jax_view_schedule(cfg, key, positions):
    """The pool indices JAX's stylize_frame draws (as
    tests/test_torch_styler.py reads them)."""
    oc = cfg.optim
    out = []
    for _ in range(oc.octave_n):
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        keys = jax.random.split(sub, oc.iters)
        out.append([[int(jax.random.randint(k, (), 0, cfg.render.view_pool))
                     for k in jax.random.split(ki, positions)]
                    for ki in keys])
    return np.asarray(out)


@pytest.mark.parametrize("window", [0, 1])
def test_remat_matches_jax_remat(vgg_np, window):
    d, vels, style = _inputs()
    over = {"optim.window": window}
    if window:
        over["render.view_pool"] = 4
    js = JaxGridStyler(jax_replace(JaxStyleConfig(), **dict(OVER, **over)),
                       vgg_params=jax.tree.map(jnp.asarray, vgg_np),
                       style_image=style)
    ts = _torch_styler(vgg_np, style, **over)
    key = jax.random.PRNGKey(3)
    sched = None
    if window:
        sched = _jax_view_schedule(js.cfg, key, positions=3)
        assert len(np.unique(sched)) > 1
    v = vels if window else None
    jd, jp, jinfo = js.stylize_frame(d, vels=v, key=key)
    td, tp, tinfo = ts.stylize_frame(d, vels=v, view_schedule=sched)
    jl = np.concatenate([np.asarray(l) for l in jinfo["octave_losses"]])
    tl = torch.cat(tinfo["octave_losses"]).numpy()
    # tests/test_torch_styler.py's tolerances and reasons: f32 rounding
    # carried through 4 Adam steps; fields within 1e-3 of a 0.16 worst case
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= 1e-3
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1e-3


@pytest.mark.parametrize("window", [0, 1])
def test_remat_equals_batched_loss(vgg_np, window):
    """The mean of per-view losses equals the batched loss (a mean over
    the batch), and the checkpointed backward gives the same gradient."""
    d, vels, style = _inputs()
    param = 0.05 * np.random.default_rng(9).standard_normal(SHAPE).astype(
        np.float32)
    results = []
    for remat in (True, False):
        ts = _torch_styler(vgg_np, style, **{"loss.remat_views": remat,
                                             "optim.window": window})
        data = {"d": torch.from_numpy(d), "pool": ts.view_pool,
                "vgg": ts.vgg_params, "targets": ts.gram_targets,
                "content": None, "vels": torch.from_numpy(vels)}
        # two distinct views per position
        views = [torch.tensor([[0.3, 0.1], [1.2, -0.2]])] * (2 * window + 1)
        p = torch.tensor(param, requires_grad=True)
        loss = ts._get_loss_fn(3, window, (32, 32))(p, views, data)
        (g,) = torch.autograd.grad(loss, p)
        results.append((loss.item(), g.numpy()))
    (lr, gr), (lb, gb) = results
    # the same float32 terms summed per view or per batch
    np.testing.assert_allclose(lr, lb, rtol=1e-6)
    np.testing.assert_allclose(gr, gb, atol=1e-6 * float(np.abs(gb).max()))
