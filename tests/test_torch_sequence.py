"""nfs_tpu_torch's fused and block-streamed sequence paths and the
mid-sequence resume, against the JAX package and against the port's own
streaming path, on the CPU.

As in tests/test_torch_styler.py both sides get the same numpy inputs and
VGG weights, and ``view_pool=1`` makes every view draw pool entry 0 on
both sides, so the JAX package's other PRNG stream on its fused path does
not matter. f32 features, W=1, 2 octaves x 2 iterations at (16, 12, 16).
The JAX package's fused and block paths keep their per-iteration losses
inside their jitted chunk functions; the tests read them by wrapping
those functions.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params
from nfs_tpu.io.stream import iter_sequence_blocks as jax_iter_blocks
from nfs_tpu.styler import grid as jax_grid
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.features.vgg import params_from_numpy
from nfs_tpu_torch.io.stream import finalize_sequence_dir, iter_sequence_blocks
from nfs_tpu_torch.styler.grid import GridStyler

torch.set_num_threads(2)

SHAPE = (16, 12, 16)
T = 5
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
}
WARM = {"optim.warm_iters": 1, "optim.warm_lr": 0.01}
STYLE = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)

# Per-iteration losses of the same optimization, f32 rounding carried
# through the Adam steps (tests/test_torch_styler.py measured <= 4e-7
# relative); d* and param within 1e-3 for the reason given there (Adam's
# normalised step magnifies near-zero gradient components of a warm
# start; 2 * lr * steps bounds any divergence).
LOSS_RTOL = 1e-5
FIELD_ATOL = 1e-3


@pytest.fixture(scope="module")
def vgg_np():
    return jax.tree.map(np.asarray, init_vgg_params(0))


def _port(vgg_np, **over):
    return GridStyler(replace(StyleConfig(), **dict(OVER, **over)),
                      vgg_params=params_from_numpy(vgg_np),
                      style_image=STYLE, device="cpu")


def _jax(vgg_np, **over):
    return jax_grid.GridStyler(
        jax_replace(JaxStyleConfig(), **dict(OVER, **over)),
        vgg_params=jax.tree.map(jnp.asarray, vgg_np), style_image=STYLE)


def _sequence():
    rng = np.random.default_rng(10)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n) for n in SHAPE],
                          indexing="ij")
    ds = np.stack([(2.0 * np.exp(-4 * (z ** 2 + (y - 0.1 * t) ** 2 + x ** 2))
                    * (1.0 + 0.2 * rng.random(SHAPE))) for t in range(T)])
    vs = 0.7 * rng.standard_normal((T,) + SHAPE + (3,))
    return ds.astype(np.float32), vs.astype(np.float32)


def _record_losses(monkeypatch, name):
    """Wrap the JAX chunk function ``name``: per frame, its (octave_n,
    iters) losses, in yield order (tail padding dropped)."""
    out = []
    orig = getattr(jax_grid, name)

    def wrapped(*args, **kw):
        param, d_stars, losses = orig(*args, **kw)
        valid = np.asarray(args[4 if name == "_seq_chunk_block" else 3])
        out.extend(np.asarray(losses)[valid])
        return param, d_stars, losses

    monkeypatch.setattr(jax_grid, name, wrapped)
    return out


def _run_jax(gen):
    """Materialize each yield at once: the next JAX chunk donates the
    carry buffer."""
    return [(t, np.asarray(d), None if p is None else np.asarray(p))
            for t, d, p in gen]


def _run_port(styler, gen):
    """(yields as numpy, per-frame (octave_n, iters) losses)."""
    outs = [(t, d.numpy(), None if p is None else p.numpy())
            for t, d, p in gen]
    return outs, [styler.frame_losses[t].numpy() for t, _, _ in outs]


def _assert_close(touts, tlosses, jouts, jlosses):
    assert [o[0] for o in touts] == [o[0] for o in jouts]
    # param yielded at the same frames (chunk / block ends)
    assert ([p is None for _, _, p in touts]
            == [p is None for _, _, p in jouts])
    np.testing.assert_allclose(np.stack(tlosses), np.stack(jlosses),
                               rtol=LOSS_RTOL)
    for (_, td, tp), (_, jd, jp) in zip(touts, jouts):
        assert np.abs(td - jd).max() <= FIELD_ATOL
        if tp is not None:
            assert np.abs(tp - jp).max() <= FIELD_ATOL


def test_fused_matches_jax_fused(vgg_np, monkeypatch):
    """fused=2 over 5 frames: chunks [0, 1], [2, 3] and a partial tail
    [4] (JAX pads it; the port runs 1 frame)."""
    ds, vs = _sequence()
    jlosses = _record_losses(monkeypatch, "_seq_chunk")
    jouts = _run_jax(_jax(vgg_np).stylize_sequence(ds, vs, fused=2))
    ts = _port(vgg_np)
    touts, tlosses = _run_port(ts, ts.stylize_sequence(ds, vs, fused=2))
    assert [p is not None for _, _, p in touts] == [False, True, False,
                                                    True, True]
    _assert_close(touts, tlosses, jouts, jlosses)


@pytest.mark.parametrize("schedule", ["cold", "warm"])
def test_fused_matches_streaming(vgg_np, schedule):
    """The port's fused path draws the streaming path's views in the same
    order, so the two agree (the JAX package's differ by PRNG stream).
    With a warm schedule frame 0 runs cold through stylize_frame."""
    over = WARM if schedule == "warm" else {}
    ds, vs = _sequence()
    ts = _port(vgg_np, **over)
    fused, fl = _run_port(ts, ts.stylize_sequence(ds, vs, fused=2))
    stream, sl = _run_port(ts, ts.stylize_sequence(ds, vs, fused=0))
    iters = 1 if schedule == "warm" else 2
    assert [l.shape for l in sl] == [(2, 2)] + [(2, iters)] * (T - 1)
    for a, b in zip(fl, sl):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for (_, fd, _), (_, sd, _) in zip(fused, stream):
        np.testing.assert_allclose(fd, sd, atol=1e-6, rtol=0)


def test_fused_with_callback_keeps_the_chunk_yields(vgg_np):
    """A callback does not change what fused=2 yields: param at the chunk
    ends (frames 1, 3) and the last frame, every frame's octaves logged."""
    ds, vs = _sequence()
    ts = _port(vgg_np, **{"optim.log_every": 1})
    calls = []
    outs = list(ts.stylize_sequence(
        ds, vs, fused=2,
        callback=lambda done, loss, octave: calls.append(octave)))
    assert [p is not None for _, _, p in outs] == [False, True, False,
                                                   True, True]
    assert calls == [0, 0, 1, 1] * T


def _write_chunk_dir(path, ds, vs, chunk):
    os.makedirs(path)
    for t0 in range(0, T, chunk):
        np.savez(os.path.join(path, f"chunk_{t0:05d}.npz"),
                 d=ds[t0:t0 + chunk], v=vs[t0:t0 + chunk])
    finalize_sequence_dir(path, T, chunk)


def test_blocks_match_jax_blocks(vgg_np, monkeypatch, tmp_path):
    """Blocks of 3 frames (a full one and a 2-frame tail), fused=2 inside
    a block, from a chunk directory read by each package's reader."""
    ds, vs = _sequence()
    path = str(tmp_path / "seq")
    _write_chunk_dir(path, ds, vs, chunk=3)
    jlosses = _record_losses(monkeypatch, "_seq_chunk_block")
    jouts = _run_jax(_jax(vgg_np).stylize_sequence_blocks(
        jax_iter_blocks(path, 1), fused=2))
    ts = _port(vgg_np)
    touts, tlosses = _run_port(ts, ts.stylize_sequence_blocks(
        iter_sequence_blocks(path, 1), fused=2))
    # param at each block's end: frames 2 and 4
    assert [p is not None for _, _, p in touts] == [False, False, True,
                                                    False, True]
    _assert_close(touts, tlosses, jouts, jlosses)


def test_blocks_with_warm_schedule_match_streaming(vgg_np, tmp_path):
    """Block path with a cold frame 0 and warm chain frames against the
    port's streaming path on the same frames."""
    ds, vs = _sequence()
    path = str(tmp_path / "seq")
    _write_chunk_dir(path, ds, vs, chunk=2)
    ts = _port(vgg_np, **WARM)
    blocks, bl = _run_port(ts, ts.stylize_sequence_blocks(
        iter_sequence_blocks(path, 1), fused=4))
    stream, sl = _run_port(ts, ts.stylize_sequence(ds, vs, fused=0))
    assert [t for t, _, _ in blocks] == list(range(T))
    for a, b in zip(bl, sl):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    for (_, bd, _), (_, sd, _) in zip(blocks, stream):
        np.testing.assert_allclose(bd, sd, atol=1e-6, rtol=0)


@pytest.mark.parametrize("fused", [0, 2])
def test_resume_from_frame_2_is_bit_equal(vgg_np, fused):
    """As tests/test_styler.py's fused resume: restart at frame 2 from the
    param yielded at frame 1, transported by velocity 1, generators keyed
    on the absolute frame: the frames equal the uninterrupted run's."""
    ds, vs = _sequence()
    ts = _port(vgg_np)
    full = [(t, d.clone(), None if p is None else p.clone())
            for t, d, p in ts.stylize_sequence(ds, vs, fused=fused)]
    carry = full[1][2]
    assert carry is not None
    resumed = list(ts.stylize_sequence(ds[2:], vs[2:], fused=fused,
                                       init_param=carry.numpy(),
                                       prev_velocity=vs[1], frame_offset=2))
    assert [t for t, _, _ in resumed] == [0, 1, 2]
    for (_, d_r, _), (_, d_f, _) in zip(resumed, full[2:]):
        assert torch.equal(d_r, d_f)


def test_resume_matches_jax_uninterrupted(vgg_np):
    """The port stopped after frame 1 and resumed at frame 2 against the
    JAX package's uninterrupted run: the same frames. (The JAX package's
    own resume takes velocity 2 as frame 2's backward window tap and
    lands 0.078 away from its uninterrupted frame 2 on these inputs;
    ROADMAP queue 3, F8.)"""
    ds, vs = _sequence()
    jouts = _run_jax(_jax(vgg_np).stylize_sequence(ds, vs, fused=0))
    ts = _port(vgg_np)
    head, _ = _run_port(ts, ts.stylize_sequence(ds[:2], vs[:2], fused=0))
    tail, _ = _run_port(ts, ts.stylize_sequence(
        ds[2:], vs[2:], fused=0, init_param=head[1][2], prev_velocity=vs[1],
        frame_offset=2))
    for (_, td, tp), (_, jd, jp) in zip(head + tail, jouts):
        assert np.abs(td - jd).max() <= FIELD_ATOL
        assert np.abs(tp - jp).max() <= FIELD_ATOL


def test_window_vels_takes_prev_before_the_first_frame():
    vels = torch.arange(4, dtype=torch.float32).view(4, 1, 1, 1, 1)
    prev = torch.full((1, 1, 1, 1), -1.0)

    def frames(t, w, p=None):
        return GridStyler._window_vels(vels, t, w, p).flatten().tolist()

    # without prev: JAX's clamped indices [max(t-W+j, 0)] + [min(t+j, T-1)]
    assert frames(0, 2) == [0, 0, 0, 1]
    assert frames(3, 2) == [1, 2, 3, 3]
    assert frames(0, 1, prev) == [-1, 0]
    assert frames(1, 2, prev) == [-1, 0, 1, 2]
