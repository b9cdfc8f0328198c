"""nfs_tpu_torch styler against the JAX package on the CPU: Adam, the
window-transport loss (value and gradient) for both parameterizations,
a 2-frame streaming sequence, and in-frame checkpoints that one package
writes and the other resumes (F16; F17, JAX's resume in octave 1).

Both sides get the same inputs: numpy-made densities, velocities and
style image, the JAX package's VGG weights carried across with
``params_from_numpy``, and ``view_pool=1`` so every view draw is pool
entry 0 whatever the PRNG (the Poisson pool itself is numpy-seeded and
identical in both packages).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params
from nfs_tpu.styler.grid import GridStyler as JaxGridStyler
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.features.vgg import params_from_numpy
from nfs_tpu_torch.styler.grid import GridStyler
from nfs_tpu_torch.styler.octave import Adam

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
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 2,
    "optim.lr": 0.02,
    "optim.window": 1,
    "optim.log_every": 1,
}


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


def _density(t=0):
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in SHAPE],
                          indexing="ij")
    noise = np.random.default_rng(10 + t).random(SHAPE)
    d = 2.0 * np.exp(-4 * (z ** 2 + (y - 0.1 * t) ** 2 + x ** 2))
    return (d * (1.0 + 0.2 * noise)).astype(np.float32)


def _velocities(n, seed=20):
    rng = np.random.default_rng(seed)
    return (0.7 * rng.standard_normal((n,) + SHAPE + (3,))).astype(
        np.float32)


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = rng.standard_normal((5, 6, 5)).astype(np.float32)
    tx = optax.adam(0.01)
    pj = jnp.asarray(p0)
    sj = tx.init(pj)
    opt = Adam(0.01)
    pt = torch.from_numpy(p0)
    st = opt.init(pt)
    for g in grads:
        u, sj = tx.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, u)
        ut, st = opt.update(torch.from_numpy(g), st)
        pt = pt + ut
    # float32 rounding of the same formula (measured max diff 1.5e-8)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-7,
                               rtol=0)


@pytest.mark.parametrize("parameterization", ["density", "velocity"])
def test_window_loss_value_and_grad(vgg_np, parameterization):
    js, ts = _stylers(vgg_np, **{"optim.parameterization": parameterization})
    rng = np.random.default_rng(3)
    d = _density()
    vels = _velocities(2)
    if parameterization == "velocity":
        param = 0.3 * rng.standard_normal(SHAPE + (3,)).astype(np.float32)
    else:
        param = 0.05 * rng.standard_normal(SHAPE).astype(np.float32)

    jloss_fn = js._get_loss_fn(3, 1, (32, 32))
    jdata = {"d": jnp.asarray(d), "pool": js.view_pool, "vgg": js.vgg_params,
             "targets": js.gram_targets, "content": None,
             "vels": jnp.asarray(vels)}
    jl, jg = jax.value_and_grad(jloss_fn)(jnp.asarray(param),
                                          jax.random.PRNGKey(0), jdata)

    tloss_fn = ts._get_loss_fn(3, 1, (32, 32))
    tdata = {"d": torch.from_numpy(d), "pool": ts.view_pool,
             "vgg": ts.vgg_params, "targets": ts.gram_targets,
             "content": None, "vels": torch.from_numpy(vels)}
    p = torch.tensor(param, requires_grad=True)
    tl = tloss_fn(p, [ts.view_pool[0]] * 3, tdata)
    (tg,) = torch.autograd.grad(tl, p)

    # the same f32 VGG, Gram and advection sums in another order:
    # measured loss rel. diff <= 1e-7 and gradient diff <= 4e-7 * max|g|;
    # 1e-5 leaves 25x room for other thread counts' summation orders
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg,
                               atol=1e-5 * float(np.abs(jg).max()))


def _run_jax_sequence(js, ds, vs):
    losses = []

    def cb(done, loss, octave):
        losses.append(loss)

    outs = [(np.asarray(d), np.asarray(p))
            for _, d, p in js.stylize_sequence(ds, vs, callback=cb,
                                               fused=0)]
    return outs, losses


def test_sequence_matches(vgg_np):
    js, ts = _stylers(vgg_np)
    ds = np.stack([_density(t) for t in range(2)])
    vs = _velocities(2, seed=30)
    jouts, jlosses = _run_jax_sequence(js, ds, vs)

    tlosses = []

    def cb(done, loss, octave):
        tlosses.append(loss)

    touts = [(d.numpy(), p.numpy())
             for _, d, p in ts.stylize_sequence(ds, vs, callback=cb,
                                                fused=0)]
    oc = ts.cfg.optim
    assert len(tlosses) == len(jlosses) == 2 * oc.octave_n * oc.iters
    # per-iteration losses of the same optimization: f32 rounding carried
    # through the Adam steps, measured rel. diff <= 4e-7
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    # Adam moves a cell by at most ~lr per step, so 2*lr*steps (0.16)
    # bounds any divergence. Measured: 2e-6 on frame 0 and 9e-5 on frame
    # 1, where Adam's normalised step magnifies near-zero gradient
    # components of the warm start; 1e-3 keeps 10x room
    bound = 1e-3
    assert bound < 2 * oc.lr * oc.octave_n * oc.iters * 2
    for (td, tp), (jd, jp) in zip(touts, jouts):
        assert td.shape == jd.shape == SHAPE
        assert np.abs(td - jd).max() <= bound
        assert np.abs(tp - jp).max() <= bound


def _jax_view_schedule(cfg, key, positions, chunk=None):
    """The pool indices JAX's stylize_frame draws: one key split per
    octave, then run_octave's split of its key per chunk of ``chunk``
    iterations (``optim.log_every`` in a run with a callback or an
    in-frame checkpoint, nfs_tpu/styler/octave.py:100-110; the whole
    octave without, the default), one key per iteration, split per
    window position (styler/grid.py:162)."""
    oc = cfg.optim
    chunk = chunk or oc.iters
    out = []
    for _ in range(oc.octave_n):
        key, sub = jax.random.split(key)
        keys = []
        for start in range(0, oc.iters, chunk):
            sub, ck = jax.random.split(sub)
            keys.extend(jax.random.split(ck, min(chunk, oc.iters - start)))
        out.append([[int(jax.random.randint(k, (), 0, cfg.render.view_pool))
                     for k in jax.random.split(ki, positions)]
                    for ki in keys])
    return np.asarray(out)


def test_view_schedule_replays_jax_draws(vgg_np):
    """With a 4-entry pool the draws matter: the port replays JAX's
    per-iteration indices through view_schedule and lands on the same
    stylization."""
    js, ts = _stylers(vgg_np, **{"render.view_pool": 4,
                                 "optim.log_every": 10})
    d = _density()
    vels = _velocities(2, seed=40)
    key = jax.random.PRNGKey(7)
    sched = _jax_view_schedule(js.cfg, key, positions=3)
    assert len(np.unique(sched)) > 1
    jd, jp, jinfo = js.stylize_frame(d, vels=vels, key=key)
    td, tp, tinfo = ts.stylize_frame(d, vels=vels, view_schedule=sched)
    jl = np.concatenate([np.asarray(l) for l in jinfo["octave_losses"]])
    tl = torch.cat(tinfo["octave_losses"]).numpy()
    # same tolerances and reasons as test_sequence_matches
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= 1e-3
    assert np.abs(tp.numpy() - np.asarray(jp)).max() <= 1e-3


# ------------------------------------------------------------------ #
# in-frame checkpoints across the packages (ROADMAP queue 3, F16, F17)
# ------------------------------------------------------------------ #

class Interrupt(Exception):
    pass


def _stop_at(stop_octave, stop_done):
    """A stylize_frame callback (both packages call it alike) raising
    after the chunk that ends at (octave, iterations done)."""
    def cb(done, loss, octave):
        if (octave, done) == (stop_octave, stop_done):
            raise Interrupt
    return cb


# a 4-entry pool (the draws matter), chunks of one iteration
CKPT = {"render.view_pool": 4, "optim.log_every": 1}


@pytest.fixture(scope="module")
def ckpt_runs(vgg_np, tmp_path_factory):
    """Both stylers at CKPT, the frame's inputs, JAX's key and the pool
    indices of its checkpointed run, and JAX's uninterrupted checkpointed
    run of the frame: (d*, param, per-octave losses)."""
    js, ts = _stylers(vgg_np, **CKPT)
    d, vels = _density(), _velocities(2, seed=40)
    key = jax.random.PRNGKey(7)
    sched = _jax_view_schedule(js.cfg, key, 3, chunk=js.cfg.optim.log_every)
    assert len(np.unique(sched)) > 1
    path = str(tmp_path_factory.mktemp("ckpt") / "ck.npz")
    jd, jp, info = js.stylize_frame(d, vels=vels, key=key,
                                    checkpoint_path=path)
    ref = (np.asarray(jd), np.asarray(jp),
           [np.asarray(l) for l in info["octave_losses"]])
    return js, ts, d, vels, key, sched, ref


def _close_to_jax(d_star, param, losses, ref, skipped):
    """Frame parity as test_view_schedule_replays_jax_draws holds it, on
    the iterations run after the first ``skipped`` of octave 0."""
    want = np.concatenate(ref[2])[skipped:]
    np.testing.assert_allclose(np.concatenate(losses), want, rtol=1e-5)
    assert np.abs(np.asarray(d_star) - ref[0]).max() <= 1e-3
    assert np.abs(np.asarray(param) - ref[1]).max() <= 1e-3


def test_port_resumes_a_jax_checkpoint(ckpt_runs, tmp_path):
    """F16: JAX's stylize_frame(checkpoint_path=) stopped after octave
    0's first chunk; the port resumes its file, replaying the draws of
    JAX's checkpointed run, and lands on JAX's uninterrupted checkpointed
    run within the frame parity tolerances."""
    js, ts, d, vels, key, sched, ref = ckpt_runs
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):
        js.stylize_frame(d, vels=vels, key=key, checkpoint_path=path,
                         callback=_stop_at(0, 1))
    with np.load(path) as z:
        assert "leaf:opt_state/0/mu" in z.files
    td, tp, info = ts.stylize_frame(d, vels=vels, view_schedule=sched,
                                    checkpoint_path=path)
    assert not (tmp_path / "ck.npz").exists()
    assert [len(l) for l in info["octave_losses"]] == [1, 2]
    _close_to_jax(td.numpy(), tp.numpy(),
                  [l.numpy() for l in info["octave_losses"]], ref, 1)


def test_jax_resumes_a_port_checkpoint(ckpt_runs, tmp_path):
    """F16: the port stopped at the same point; JAX resumes the port's
    file and completes the frame, within the same tolerances of its own
    uninterrupted checkpointed run."""
    js, ts, d, vels, key, sched, ref = ckpt_runs
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):
        ts.stylize_frame(d, vels=vels, view_schedule=sched,
                         checkpoint_path=path, callback=_stop_at(0, 1))
    jd, jp, info = js.stylize_frame(d, vels=vels, key=key,
                                    checkpoint_path=path)
    assert not (tmp_path / "ck.npz").exists()
    assert [len(l) for l in info["octave_losses"]] == [1, 2]
    _close_to_jax(jd, jp, info["octave_losses"], ref, 1)


def test_jax_resume_in_octave_1_leaves_its_run(ckpt_runs, tmp_path):
    """F17, a reference quirk kept as it is: JAX skips the finished
    octaves before their per-octave key split (nfs_tpu/styler/grid.py:
    643, :661), so its resume in octave 1 draws other views than its
    uninterrupted run and lands off it. The port replays the skipped
    octaves' draws and resumes in octave 1 with its run's bits
    (tests/test_torch_checkpoint.py test_frame_resume_is_bit_equal)."""
    js, _, d, vels, key, _, ref = ckpt_runs
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):
        js.stylize_frame(d, vels=vels, key=key, checkpoint_path=path,
                         callback=_stop_at(1, 1))
    jd, jp, _ = js.stylize_frame(d, vels=vels, key=key,
                                 checkpoint_path=path)
    assert np.abs(np.asarray(jp) - ref[1]).max() > 0


def test_not_ported_options_raise(vgg_np):
    """Nothing of the grid path is refused any more: per-view
    rematerialization (once item 10) and the exact advection path,
    max_disp=None (once item 12), build and run (their parity is in
    tests/test_torch_remat.py and tests/test_torch_advect_exact.py)."""
    from nfs_tpu_torch.ops.advect import advect

    _, ts = _stylers(vgg_np)
    style = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)
    remat = GridStyler(
        replace(StyleConfig(), **dict(OVER, **{
            "loss.remat_views": True, "optim.max_disp": None,
            "optim.octave_n": 1})),
        vgg_params=ts.vgg_params, style_image=style, device="cpu")
    d_star, _, info = remat.stylize_frame(_density(), vels=_velocities(2))
    assert d_star.shape == SHAPE and torch.isfinite(d_star).all()
    assert len(info["octave_losses"][0]) == OVER["optim.iters"]
    out = advect(torch.ones(SHAPE), torch.full(SHAPE + (3,), 5.0),
                 max_disp=None)
    assert torch.equal(out, torch.ones(SHAPE))


def test_tf32_off_from_styler_not_import(vgg_np):
    """Importing the package leaves torch's TF32 switches alone; building
    a GridStyler turns both off for its float32 work."""
    import nfs_tpu_torch

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        importlib.reload(nfs_tpu_torch)
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        _stylers(vgg_np)
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
