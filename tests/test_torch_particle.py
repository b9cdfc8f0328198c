"""nfs_tpu_torch ParticleStyler against the JAX package on the CPU: Adam
over a param dict, ``stylize_frame`` on every splat route, the overflow
warning, and ``stylize_keyframes`` over a 5-frame sequence.

Both sides get the same inputs: numpy-made particles and style image, the
JAX package's VGG weights carried across with ``params_from_numpy``, f32
features, and ``view_pool=1`` so every view draw is pool entry 0 whatever
the PRNG. Where JAX takes its Pallas window (``splat_impl=
'binned_pallas'``, interpret mode off a TPU), the port takes
``splat_binned_window`` (the plain versions of K4/K5 on the CPU).

Tolerances: per-iteration losses rtol 1e-5 (f32 VGG, Gram and splat sums
in another order, measured <= 1.4e-6). Final dx / ddens and positions
atol 2e-4: Adam's normalised step turns f32 rounding of near-zero
gradient components into moves of up to ~1e-3 of lr per step (measured
<= 4.7e-5 after 6 steps at lr 0.05).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from nfs_tpu_torch.styler.octave import Adam

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
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.05,
    "optim.log_every": 1,
}
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4


@pytest.fixture(scope="module")
def vgg_np():
    return jax.tree.map(np.asarray, init_vgg_params(0))


def _stylers(vgg_np, jax_over=None, **over):
    kw = dict(OVER, **over)
    style = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)
    js = JP.ParticleStyler(
        jax_replace(JaxStyleConfig(), **dict(kw, **(jax_over or {}))),
        grid_shape=GRID, vgg_params=jax.tree.map(jnp.asarray, vgg_np),
        style_image=style)
    ts = TP.ParticleStyler(replace(StyleConfig(), **kw), grid_shape=GRID,
                           vgg_params=params_from_numpy(vgg_np),
                           style_image=style, device="cpu")
    return js, ts


def _particles(n=600, seed=0, t=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)) * (np.array(GRID) - 4) + 2
    c = np.array(GRID) / 2.0
    r = x - c
    for _ in range(t):   # a swirl about the y axis, as the benches do
        r = r + 0.05 * np.stack([-r[:, 2], 0.3 * np.ones(n), r[:, 0]], -1)
    dens = 0.5 + rng.random(n)
    return (r + c).astype(np.float32), dens.astype(np.float32)


def _frame(styler_run, x, dens, **kw):
    losses = []
    styled, param, info = styler_run(
        x, dens, callback=lambda done, loss, octave: losses.append(loss),
        **kw)
    return styled, param, info, losses


def _jax_frame(js, x, dens, **kw):
    return _frame(lambda x, d, **k: js.stylize_frame(
        JaxParticleSet(x=jnp.asarray(x), dens=jnp.asarray(d)), **k),
        x, dens, **kw)


def _torch_frame(ts, x, dens, **kw):
    return _frame(lambda x, d, **k: ts.stylize_frame(
        ParticleSet(x=x, dens=d), **k), x, dens, **kw)


def _assert_frames_match(j, t):
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
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x),
                               atol=PARAM_ATOL, rtol=0)
    np.testing.assert_allclose(tst.dens.numpy(), np.asarray(jst.dens),
                               atol=PARAM_ATOL, rtol=0)


def test_adam_on_a_dict_matches_optax():
    rng = np.random.default_rng(0)
    p0 = {"dx": rng.standard_normal((7, 3)).astype(np.float32),
          "ddens": rng.standard_normal(7).astype(np.float32)}
    tx = optax.adam(0.01)
    pj = jax.tree.map(jnp.asarray, p0)
    sj = tx.init(pj)
    opt = Adam(0.01)
    pt = {k: torch.from_numpy(v) for k, v in p0.items()}
    st = opt.init(pt)
    for _ in range(5):
        g = {"dx": rng.standard_normal((7, 3)).astype(np.float32),
             "ddens": rng.standard_normal(7).astype(np.float32)}
        u, sj = tx.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, u)
        ut, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                            st)
        pt = {k: pt[k] + ut[k] for k in pt}
    assert st.count == 5
    # float32 rounding of the same formula
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   atol=1e-7, rtol=0)


@pytest.mark.parametrize("case,over,jax_over", [
    # (a) position only, binned coarse octaves, against both JAX layouts
    ("window_slots", {},
     {"particle.splat_impl": "binned_pallas",
      "particle.binned_layout": "slots"}),
    ("window_shifted", {}, {"particle.splat_impl": "binned_pallas"}),
    # (b) position + density: the grid-space coarse octave (prep splat,
    # run_octave over g, grid_sample transfer), then the window octave
    ("grid_coarse", {"particle.optimize_density": True},
     {"particle.splat_impl": "binned_pallas"}),
    # the plain generic binned splat, rebinned every 2 iterations
    ("binned", {"particle.splat_impl": "binned",
                "particle.rebin_every": 2}, {}),
    # (c) the flat splat
    ("flat", {"particle.splat_impl": "flat",
              "particle.optimize_density": True}, {}),
])
def test_stylize_frame_matches_jax(vgg_np, case, over, jax_over):
    js, ts = _stylers(vgg_np, jax_over, **over)
    x, dens = _particles()
    _assert_frames_match(_jax_frame(js, x, dens), _torch_frame(ts, x, dens))


def test_overflow_warning_matches_jax(vgg_np):
    """(d) The bin plan of a spread frame is reused on a crowded one, which
    then parks particles: the same counts and the same warning as JAX,
    and the plan is dropped so the next frame re-probes."""
    js, ts = _stylers(vgg_np, {"particle.splat_impl": "binned_pallas"},
                      **{"particle.k_budget": None})
    x, dens = _particles(400)
    crowded = x.copy()
    crowded[:150] = 6.0 + 0.05 * np.random.default_rng(2).random((150, 3))
    for run, styler in ((_jax_frame, js), (_torch_frame, ts)):
        run(styler, x, dens)
        assert len(styler._k_cache) == 1
    with pytest.warns(UserWarning) as jw:
        jres = _jax_frame(js, crowded, dens)
    with pytest.warns(UserWarning) as tw:
        tres = _torch_frame(ts, crowded, dens)
    jmsg = [str(w.message) for w in jw if "parked" in str(w.message)]
    tmsg = [str(w.message) for w in tw if "parked" in str(w.message)]
    assert tmsg == jmsg and len(tmsg) == 1
    assert min(tres[2]["octave_overflow"]) > 0
    _assert_frames_match(jres, tres)
    assert not ts._k_cache and not js._k_cache


def test_stylize_keyframes_matches_jax(vgg_np):
    """5 frames with stride 2: keyframes 0, 2 and 4, each warm-started
    from the last, and the interpolated frames between them."""
    over = {"particle.optimize_density": True,
            "particle.keyframe_stride": 2, "optim.iters": 2}
    js, ts = _stylers(vgg_np, {"particle.splat_impl": "binned_pallas"},
                      **over)
    frames = [_particles(t=t) for t in range(5)]
    jout = list(js.stylize_keyframes(
        [JaxParticleSet(x=jnp.asarray(x), dens=jnp.asarray(d))
         for x, d in frames]))
    tout = list(ts.stylize_keyframes(
        [ParticleSet(x=x, dens=d) for x, d in frames]))
    assert [t for t, _ in tout] == [t for t, _ in jout] == list(range(5))
    for (_, tp), (_, jp) in zip(tout, jout):
        np.testing.assert_allclose(tp.x.numpy(), np.asarray(jp.x),
                                   atol=PARAM_ATOL, rtol=0)
        np.testing.assert_allclose(tp.dens.numpy(), np.asarray(jp.dens),
                                   atol=PARAM_ATOL, rtol=0)
    assert sorted(ts.last_keyframe_infos) == sorted(js.last_keyframe_infos)
    for kf, info in js.last_keyframe_infos.items():
        np.testing.assert_allclose(
            torch.cat(ts.last_keyframe_infos[kf]["octave_losses"]).numpy(),
            np.concatenate([np.asarray(l) for l in info["octave_losses"]]),
            rtol=LOSS_RTOL)


def test_keyframe_helpers_match_jax():
    for T, stride in ((1, 10), (5, 2), (11, 10), (7, 3), (4, 0)):
        assert TP.keyframe_indices(T, stride) == JP.keyframe_indices(
            T, stride)
    rng = np.random.default_rng(3)
    p0 = {"dx": rng.standard_normal((6, 3)).astype(np.float32),
          "ddens": rng.standard_normal(6).astype(np.float32)}
    p1 = {k: v + 1.0 for k, v in p0.items()}
    got = TP.interpolate_attrs(TP.param_from_numpy(p0),
                               TP.param_from_numpy(p1), 0.3)
    want = JP.interpolate_attrs(p0, p1, 0.3)
    for k in p0:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-7, rtol=0)
    back = TP.param_to_numpy(TP.param_from_numpy(p0))
    assert sorted(back) == sorted(p0)
    for k in p0:
        np.testing.assert_array_equal(back[k], p0[k])


def test_rasterize_matches_jax(vgg_np):
    js, ts = _stylers(vgg_np)
    x, dens = _particles(300, seed=4)
    np.testing.assert_allclose(
        ts.rasterize(ParticleSet(x=x, dens=dens)).numpy(),
        np.asarray(js.rasterize(JaxParticleSet(x=jnp.asarray(x),
                                               dens=jnp.asarray(dens)))),
        atol=1e-5, rtol=0)


def test_not_ported_options_raise(vgg_np):
    """Nothing of the particle path is refused any more: 2D grids,
    particle colour and transfer functions, once refused with items 6 and
    15, build (their parity is in tests/test_torch_particle_color.py)."""
    vgg = params_from_numpy(vgg_np)
    two_d = TP.ParticleStyler(StyleConfig(), grid_shape=(16, 16),
                              vgg_params=vgg, device="cpu")
    assert two_d.view_pool is None
    color = TP.ParticleStyler(
        replace(StyleConfig(), **{"particle.optimize_color": True}),
        grid_shape=GRID, vgg_params=vgg, device="cpu")
    x, dens = _particles(50)
    assert sorted(color.init_param(ParticleSet(x=x, dens=dens))) == [
        "color", "dx"]
    tf = TP.ParticleStyler(
        replace(StyleConfig(), **{"render.transfer_fn": "fire"}),
        grid_shape=GRID, vgg_params=vgg, device="cpu")
    assert tuple(tf.tf_nodes.shape) == (8, 3)
