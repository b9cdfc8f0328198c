"""nfs_tpu_torch's ParallelSequenceStyler against the JAX package's on the
CPU: 3D, 2D and the velocity parameterization on a (1, 1) mesh in this
process, and on 4 gloo ranks: a (2, 2) mesh against JAX's (2, 2) mesh
(frames and views both padded), and the mesh invariance of (2, 2),
(4, 1) with 6 frames on 4 frame shards, (1, 2) with 9 views on 2 view
shards, a TV term and two ranks left over, the velocity parameterization
and 2D
against the port's own (1, 1) run. Every rank must return the same
gathered result.

Both packages load one VGG weights file and the same style image, and the
port replays JAX's per-(frame, octave, iteration) view draws through
``view_schedule``. Tolerances are those of tests/test_parallel_engine.py:
losses rtol 1e-4, d* rtol 1e-3 and atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params, save_vgg_params
from nfs_tpu.parallel import ParallelSequenceStyler as JaxEngine
from nfs_tpu.parallel import make_mesh as jax_make_mesh
from nfs_tpu.styler.grid import GridStyler as JaxGridStyler
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.parallel import ParallelSequenceStyler, make_mesh
from nfs_tpu_torch.styler.grid import GridStyler
from test_torch_parallel_ranks import run_ranks

torch.set_num_threads(2)

SHAPE3, SHAPE2 = (12, 8, 12), (24, 16)
STYLE = np.random.default_rng(0).random((32, 32, 3), dtype=np.float32)
BASE = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 4,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1", "relu2_1"),
    "loss.style_layer_weights": (1.0, 1.0),
    # at w_style 1 the random VGG's gradients are ~1e-8, where Adam's eps
    # turns f32 rounding into whole steps
    "loss.w_style": 1000.0,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.log_every": 2,
    "optim.window": 1,
    "optim.lr": 0.02,
}
LOSS_RTOL, D_RTOL, D_ATOL = 1e-4, 1e-3, 1e-5


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
    save_vgg_params(path, init_vgg_params(0))
    return path


def _over(vgg_path, **kw):
    return dict(BASE, **{"loss.vgg_weights": vgg_path}, **kw)


def _data(T, shape, seed):
    rng = np.random.default_rng(seed)
    ds = rng.random((T,) + shape).astype(np.float32)
    vs = (0.5 * rng.standard_normal((T,) + shape + (len(shape),))).astype(
        np.float32)
    return ds, vs


def _jax_draws(T, octaves, iters, pool, seed=0):
    """The JAX engine's view draws: frame t, octave o, iteration it takes
    pool[randint(fold_in(fold_in(fold_in(fold_in(key, t), o), it), 1))]
    (nfs_tpu/parallel/engine.py and sharding.py)."""
    key = jax.random.PRNGKey(seed)

    def one(t, o, it):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            key, t), o), it)
        return jax.random.randint(jax.random.fold_in(k, 1), (), 0, pool)

    grid = jnp.meshgrid(jnp.arange(T), jnp.arange(octaves),
                        jnp.arange(iters), indexing="ij")
    return np.asarray(jax.vmap(one)(*(g.reshape(-1) for g in grid))
                      ).reshape(T, octaves, iters)


def _run_jax(over, ds, vs, mesh):
    calls = []
    styler = JaxGridStyler(jax_replace(JaxStyleConfig(), **over),
                           style_image=STYLE)
    d, p, info = JaxEngine(styler, jax_make_mesh(*mesh)).stylize(
        ds, vs, callback=lambda done, loss, octave: calls.append(
            (done, loss, octave)))
    return (np.asarray(d), np.asarray(p),
            [np.asarray(l) for l in info["octave_losses"]], calls)


def _run_port(over, ds, vs, schedule=None, callback=None):
    styler = GridStyler(replace(StyleConfig(), **over), style_image=STYLE,
                        device="cpu")
    engine = ParallelSequenceStyler(styler, make_mesh(1, 1))
    d, p, info = engine.stylize(ds, vs, view_schedule=schedule,
                                callback=callback)
    return d.numpy(), p.numpy(), [l.numpy() for l in info["octave_losses"]]


def _close(got, want, losses=True):
    (d, p, l), (wd, wp, wl) = got[:3], want[:3]
    assert d.shape == wd.shape and p.shape == wp.shape
    if losses:
        for a, b in zip(l, wl):
            np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    np.testing.assert_allclose(d, wd, rtol=D_RTOL, atol=D_ATOL)
    np.testing.assert_allclose(p, wp, rtol=D_RTOL, atol=D_ATOL)


# ------------------------------------------------------------------ #
# (1, 1) in this process against JAX's (1, 1)
# ------------------------------------------------------------------ #

SINGLE = {
    "3d": ({}, SHAPE3, 3, True),
    "2d": ({"optim.octave_n": 1}, SHAPE2, 3, True),
    "velocity": ({"optim.parameterization": "velocity", "optim.window": 0,
                  "optim.octave_n": 1}, SHAPE3, 2, False),
}


@pytest.mark.parametrize("name", sorted(SINGLE))
def test_single_mesh_matches_jax(vgg_path, name):
    extra, shape, T, window = SINGLE[name]
    over = _over(vgg_path, **extra)
    ds, vs = _data(T, shape, seed=len(name))
    vs = vs if window else None
    want = _run_jax(over, ds, vs, (1, 1))
    schedule = _jax_draws(T, over["optim.octave_n"], 3, 4)
    calls = []
    got = _run_port(over, ds, vs, schedule if len(shape) == 3 else None,
                    lambda done, loss, octave: calls.append(
                        (done, loss, octave)))
    _close(got, want)
    assert got[0].min() >= 0.0
    # the callback: after iterations 2 and 3 of each octave, the last loss
    assert [c[::2] for c in calls] == [c[::2] for c in want[3]]
    np.testing.assert_allclose([c[1] for c in calls],
                               [c[1] for c in want[3]], rtol=LOSS_RTOL)


# ------------------------------------------------------------------ #
# 4 gloo ranks
# ------------------------------------------------------------------ #

def _runs(vgg_path):
    """The runs of the rank processes: config overrides, mesh, inputs
    and (for the run held against JAX) view draws."""
    runs = []
    # (2, 2): 3 frames padded to 4, 3 views padded to 4, JAX's draws
    ds, vs = _data(3, SHAPE3, seed=10)
    over = _over(vgg_path, **{"render.n_views": 3})
    runs.append(dict(over=over, mesh=(2, 2), d=ds, v=vs,
                     schedule=_jax_draws(4, 2, 3, 4), style=STYLE))
    # (4, 1): 6 frames on 4 frame shards
    ds, vs = _data(6, SHAPE3, seed=11)
    runs.append(dict(over=_over(vgg_path, **{"optim.octave_n": 1}),
                     mesh=(4, 1), d=ds, v=vs, style=STYLE))
    # (1, 2): 9 views on 2 view shards, ranks 2 and 3 left over; each
    # views rank adds its share of the TV term (ROADMAP F10)
    ds, _ = _data(2, SHAPE3, seed=12)
    runs.append(dict(over=_over(vgg_path, **{
        "render.n_views": 9, "optim.window": 0, "optim.octave_n": 1,
        "loss.w_tv": 0.5}),
        mesh=(1, 2), d=ds, v=None, style=STYLE))
    # (2, 2): the velocity parameterization
    ds, _ = _data(4, SHAPE3, seed=13)
    runs.append(dict(over=_over(vgg_path, **{
        "optim.parameterization": "velocity", "optim.window": 0,
        "optim.octave_n": 1}), mesh=(2, 2), d=ds, v=None, style=STYLE))
    # (2, 2): 2D with the window
    ds, vs = _data(4, SHAPE2, seed=14)
    runs.append(dict(over=_over(vgg_path, **{"optim.octave_n": 1}),
                     mesh=(2, 2), d=ds, v=vs, style=STYLE))
    return runs


@pytest.fixture(scope="module")
def engine_ranks(vgg_path, tmp_path_factory):
    runs = _runs(vgg_path)
    out = run_ranks("engine", {"runs": runs}, 4,
                    tmp_path_factory.mktemp("engine"))
    return runs, out


RUN_NAMES = ["2x2_padded", "4x1_six_frames", "1x2_nine_views",
             "2x2_velocity", "2x2_2d"]


@pytest.mark.parametrize("i", range(len(RUN_NAMES)), ids=RUN_NAMES)
def test_mesh_runs_match_single_mesh(engine_ranks, i):
    """Every rank returns the same gathered result, and it is the (1, 1)
    run's: the view draws do not depend on the mesh, and the views
    all_reduce gives each views rank the whole gradient."""
    runs, out = engine_ranks
    run = runs[i]
    first = out[0][i]
    for r in out[1:]:
        for k in ("d", "params"):
            np.testing.assert_array_equal(r[i][k], first[k])
    ref = _run_port(run["over"], run["d"], run["v"], run.get("schedule"))
    got = (first["d"], first["params"], first["losses"])
    # a padded mesh averages its losses over the padding frames too, so
    # the losses are compared where the padded T is the same
    T = run["d"].shape[0]
    _close(got, ref, losses=T % run["mesh"][0] == 0)
    assert got[0].shape[0] == T and got[0].min() >= 0.0


def test_padded_mesh_matches_jax_mesh(engine_ranks):
    """The (2, 2) run with 3 frames and 3 views (both padded) against the
    JAX engine on a (2, 2) mesh of virtual devices, with its draws."""
    runs, out = engine_ranks
    run, got = runs[0], out[0][0]
    want = _run_jax(run["over"], run["d"], run["v"], (2, 2))
    _close((got["d"], got["params"], got["losses"]), want)
    c = got["collectives"]
    # per chunk of each octave one views all_reduce per iteration and one
    # frames sum; one halo exchange per chunk (rank 0: one send, one
    # receive); the d* and params gathers
    assert c == {"all_reduce": 2 * (3 + 1), "send": 2, "recv": 2,
                 "all_gather": 2, "broadcast": 0}


def test_leftover_ranks_receive_the_result(engine_ranks):
    _, out = engine_ranks
    c = [r[2]["collectives"] for r in out]
    assert c[2]["broadcast"] == c[3]["broadcast"] == 3
    assert c[2]["all_reduce"] == 0 and c[0]["all_reduce"] > 0
