"""nfs_tpu_torch's composed (frames, views, space) engine against the JAX
package's on the CPU (counterparts of
``tests/test_parallel_engine.py``'s composed-mesh and fallback tests): on
4 gloo ranks (``test_torch_parallel_ranks.py``, scenario ``spatial``)
each frame's volume is split into y-slabs over ``space`` as well, and a
run must match the same run on the (frames, views) mesh without the
space axis and JAX's run on the same composed mesh of virtual devices.

Inputs as in ``tests/test_torch_spatial.py``: one VGG weights file, one
style image, ``render.view_pool`` 1, style weight 1000. Tolerances are
those of ``tests/test_parallel_engine.py``: losses rtol 1e-4, d* and
params rtol 1e-3, atol 1e-5. An octave that runs replicated over space
computes what the mesh without it computes, bit for bit.
"""

import numpy as np
import pytest

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params, save_vgg_params
from nfs_tpu.parallel import ParallelSequenceStyler as JaxEngine
from nfs_tpu.parallel import make_mesh as jax_make_mesh
from nfs_tpu.styler.grid import GridStyler as JaxGridStyler
from test_torch_parallel_ranks import run_ranks

STYLE = np.random.default_rng(0).random((32, 32, 3), dtype=np.float32)
BASE = {
    "render.render_size": (32, 32),
    "render.n_views": 2,
    "render.view_pool": 1,
    "render.transmit": 0.05,
    "loss.style_layers": ("relu1_1",),
    "loss.style_layer_weights": (1.0,),
    "loss.w_style": 1000.0,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.02,
    "optim.window": 1,
}
LOSS_RTOL, D_RTOL, D_ATOL = 1e-4, 1e-3, 1e-5


def _data(T, shape, seed):
    rng = np.random.default_rng(seed)
    ds = rng.random((T,) + shape).astype(np.float32)
    vs = (0.2 * rng.standard_normal((T,) + shape + (3,))).astype(np.float32)
    return ds, vs


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
    save_vgg_params(path, init_vgg_params(0))
    return path


# name: (config overrides, frames, shape, window, composed mesh, the mesh
# without space)
RUNS = {
    # y 12 and 6 on 2 slabs: 6 and 3 rows, the 3-row halo of max_disp 2
    "window": ({}, 4, (16, 12, 16), True, (2, 1, 2), (2, 1)),
    "velocity": ({"optim.parameterization": "velocity", "optim.window": 0,
                  "optim.octave_n": 1}, 2, (8, 12, 8), False, (1, 2, 2),
                 (1, 2)),
    # y 9 does not divide by 2: the octave runs replicated, with a warning
    "fallback": ({"optim.window": 0, "optim.octave_n": 1}, 2,
                 (12, 9, 12), False, (2, 1, 2), (2, 1)),
}


def _over(vgg_path, name):
    return dict(BASE, **{"loss.vgg_weights": vgg_path}, **RUNS[name][0])


@pytest.fixture(scope="module")
def ranks(vgg_path, tmp_path_factory):
    """Each run on its composed mesh and on the mesh without space, on one
    4-rank world: {(name, mesh): per-rank results}."""
    keys, cases = [], []
    for i, (name, (_, T, shape, window, m3, m2)) in enumerate(RUNS.items()):
        ds, vs = _data(T, shape, seed=20 + i)
        for mesh in (m3, m2):
            keys.append((name, mesh))
            cases.append({"kind": "engine", "mesh": mesh, "d": ds,
                          "v": vs if window else None,
                          "over": _over(vgg_path, name), "style": STYLE})
    out = run_ranks("spatial", {"cases": cases}, 4,
                    tmp_path_factory.mktemp("spatial_engine"))
    return {k: [r[i] for r in out] for i, k in enumerate(keys)}


def _close(got, want):
    for a, b in zip(got["losses"], want["losses"]):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    for k in ("d", "params"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=D_RTOL,
                                   atol=D_ATOL)


@pytest.mark.parametrize("name", ["window", "velocity"])
def test_composed_mesh_matches_2axis(ranks, name):
    """Sharding each frame's volume over space is a placement, not a
    change of the math: every rank returns the (frames, views) mesh's
    result; the slabs exchanged halos and gathered the volume, and every
    slab each octave's step held (params, densities, window velocities)
    had storage of its own."""
    m3, m2 = RUNS[name][4:]
    got = ranks[(name, m3)]
    assert all(r["owns"] for r in got)
    for r in got[1:]:
        for k in ("d", "params"):
            np.testing.assert_array_equal(r[k], got[0][k])
    _close(got[0], ranks[(name, m2)][0])
    assert got[0]["d"].min() >= 0.0
    c = got[0]["collectives"]
    assert c["send"] > 0 and c["all_gather"] > 0
    assert not any(r["warnings"] for r in got)


def test_composed_mesh_matches_jax(ranks, vgg_path):
    """The W=1 run on (2, 1, 2) against the JAX engine on the same mesh
    of virtual devices, GSPMD sharding each frame over space."""
    _, T, shape, _, m3, _ = RUNS["window"]
    ds, vs = _data(T, shape, seed=20)
    styler = JaxGridStyler(jax_replace(JaxStyleConfig(),
                                       **_over(vgg_path, "window")),
                           style_image=STYLE)
    d, p, info = JaxEngine(styler, jax_make_mesh(*m3)).stylize(ds, vs)
    want = {"d": np.asarray(d), "params": np.asarray(p),
            "losses": [np.asarray(l) for l in info["octave_losses"]]}
    _close(ranks[("window", m3)][0], want)


def test_space_fallback_warns(ranks):
    """A y size that does not divide by the space axis: the octave runs
    replicated over space, says so in the JAX engine's words on every
    rank that holds a shard, and gives the (frames, views) mesh's result
    bit for bit."""
    m3, m2 = RUNS["fallback"][4:]
    got, ref = ranks[("fallback", m3)], ranks[("fallback", m2)]
    for r in got:
        assert len(r["warnings"]) == 1
        assert "divisible by the space mesh axis" in r["warnings"][0]
        assert r["d"].shape == (2, 12, 9, 12)
        for k in ("d", "params"):
            np.testing.assert_array_equal(r[k], ref[0][k])
