"""nfs_tpu_torch's ParallelKeyframeStyler (keyframe-parallel LNST)
against the JAX package's on the CPU, at the sizes of
tests/test_parallel_particles.py (16x12x16, 350 particles, 32^2 renders,
relu1_1): 3D and 2D keyframes, the linear kernel and colour on a (1, 1)
mesh in this process against JAX's engine; against the port's own
independent ``stylize_frame`` calls, also where the keyframes plan
different bin capacities (F11); the fallback to the sequential path
(``support`` 1.5); ``last_keyframe_infos``; and on 4 gloo ranks the mesh
invariance of (2, 1) and (4, 1) meshes (3 keyframes: both pad) and of a
(2, 2) mesh, against the (1, 1) run.

Both packages load one VGG weights file and the same style image; the
port replays JAX's per-(keyframe, octave, iteration) view draws
(``fold_in(key, kf)``, then the engine's splits) through
``view_schedule``. Tolerances are those of the JAX file: particles and
densities rtol 4e-3 and atol 4e-4 against JAX (f32 sums in another
order, amplified by Adam's normalised steps), 1e-4 / 1e-5 across meshes,
positions held as offsets from their input frame.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.core.pytrees import ParticleSet as JaxParticleSet
from nfs_tpu.features.vgg import init_vgg_params, save_vgg_params
from nfs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nfs_tpu.parallel.particles import (
    ParallelKeyframeStyler as JaxKeyframeStyler)
from nfs_tpu.styler.particle import ParticleStyler as JaxParticleStyler
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.parallel import ParallelKeyframeStyler, make_mesh
from nfs_tpu_torch.parallel.particles import keyframe_generator
from nfs_tpu_torch.styler.particle import (
    ParticleStyler, interp_sequence, keyframe_indices)
from test_torch_parallel_ranks import run_ranks

torch.set_num_threads(2)

SHAPE, SHAPE2 = (16, 12, 16), (24, 24)
STYLE = np.random.default_rng(3).random((32, 32, 3)).astype(np.float32)
BASE = {
    "render.render_size": (32, 32),
    "render.n_views": 2,
    "render.view_pool": 4,
    "render.transmit": 0.3,
    "optim.octave_n": 2,
    "optim.iters": 4,
    "optim.lr": 0.05,
    "loss.style_layers": ("relu1_1",),
    "loss.style_layer_weights": (1.0,),
    "particle.optimize_position": True,
    "particle.optimize_density": True,
    "particle.keyframe_stride": 2,
    "particle.rebin_every": 3,
}
RTOL, ATOL = 4e-3, 4e-4
MESH_RTOL, MESH_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
    save_vgg_params(path, init_vgg_params(0))
    return path


def _over(vgg_path, **kw):
    return dict(BASE, **{"loss.vgg_weights": vgg_path}, **kw)


def _frames(T, n=350, seed=0, shape=SHAPE, color=False):
    """(x, dens, color) numpy arrays of T frames drifting from one cloud."""
    rng = np.random.default_rng(seed)
    x0 = rng.random((n, len(shape))) * (np.asarray(shape) - 4.0) + 2.0
    drift = rng.normal(size=(n, len(shape))) * 0.15
    col = rng.random((n, 3), dtype=np.float32) if color else None
    return [((x0 + t * drift).astype(np.float32),
             (0.5 + rng.random(n)).astype(np.float32), col)
            for t in range(T)]


def _psets(frames):
    return [ParticleSet(x=x, dens=d, color=c) for x, d, c in frames]


def _styler(over, shape=SHAPE):
    return ParticleStyler(replace(StyleConfig(), **over), grid_shape=shape,
                          style_image=STYLE, device="cpu")


def _jax_draws(over, keyframes, seed=0):
    """The JAX engine's view draws, (B, octave_n, iters): keyframe kf's
    key is fold_in(PRNGKey(seed), kf); per octave key, okey = split(key);
    per chunk (the whole octave in a grid-space coarse octave, else
    particle.rebin_every iterations) okey, s2 = split(okey) and the
    chunk's keys split(s2, steps); iteration i takes randint(keys[i], (),
    0, view_pool) (nfs_tpu/parallel/particles.py, styler/particle.py)."""
    octaves, iters = over["optim.octave_n"], over["optim.iters"]
    pool, rebin = over["render.view_pool"], over["particle.rebin_every"]
    grid_coarse = over["particle.optimize_density"] and octaves > 1
    out = np.zeros((len(keyframes), octaves, iters), np.int64)
    for b, kf in enumerate(keyframes):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), kf)
        for o in range(octaves):
            key, okey = jax.random.split(key)
            chunk = iters if grid_coarse and o < octaves - 1 else rebin
            done = 0
            while done < iters:
                steps = min(chunk, iters - done)
                okey, s2 = jax.random.split(okey)
                for i, k in enumerate(jax.random.split(s2, steps)):
                    out[b, o, done + i] = int(
                        jax.random.randint(k, (), 0, pool))
                done += steps
    return out


def _run_jax(over, frames, shape=SHAPE, frames_axis=1):
    styler = JaxParticleStyler(jax_replace(JaxStyleConfig(), **over),
                               grid_shape=shape, style_image=STYLE)
    engine = JaxKeyframeStyler(styler, mesh=jax_make_mesh(
        frames=frames_axis))
    psets = [JaxParticleSet(x=jnp.asarray(x), dens=jnp.asarray(d),
                            color=None if c is None else jnp.asarray(c))
             for x, d, c in frames]
    outs = [(t, np.asarray(p.x), np.asarray(p.dens),
             None if p.color is None else np.asarray(p.color))
            for t, p in engine.stylize_keyframes(psets)]
    return outs, engine.last_keyframe_infos


def _run_port(over, frames, shape=SHAPE, schedule=None, mesh=(1, 1)):
    engine = ParallelKeyframeStyler(_styler(over, shape), make_mesh(*mesh))
    outs = [_numpy(t, p) for t, p in engine.stylize_keyframes(
        _psets(frames), view_schedule=schedule)]
    return outs, engine


def _numpy(t, p):
    """(t, x, dens, colour or None) of a yielded ParticleSet."""
    color = None if p.color is None else np.asarray(torch.as_tensor(p.color))
    return t, p.x.numpy(), p.dens.numpy(), color


def _close(got, want, frames, rtol=RTOL, atol=ATOL):
    """Frame indices equal; position offsets from the input ``frames``,
    densities and colours close (on absolute positions rtol would hide a
    wrong offset)."""
    assert [o[0] for o in got] == [o[0] for o in want]
    for g, w in zip(got, want):
        x_in = frames[g[0]][0]
        for i, (a, b) in enumerate(zip(g[1:], w[1:])):
            assert (a is None) == (b is None)
            if i == 0:
                a, b = a - x_in, b - x_in
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _moved(outs, frames):
    return max(float(np.abs(o[1] - frames[o[0]][0]).max()) for o in outs)


# ------------------------------------------------------------------ #
# (1, 1) in this process
# ------------------------------------------------------------------ #

CASES = {
    # (extra config, frames, grid, particles, colour)
    "3d": ({}, 5, SHAPE, 350, False),
    "2d": ({"optim.iters": 2, "optim.octave_n": 1}, 3, SHAPE2, 200, False),
    "linear": ({"particle.kernel": "linear", "optim.iters": 3,
                "optim.octave_n": 1}, 3, SHAPE, 200, False),
    "color": ({"particle.optimize_color": True, "loss.w_style": 1000.0,
               "optim.iters": 3}, 3, SHAPE, 300, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_jax(vgg_path, name):
    """The engine on a (1, 1) mesh against JAX's ParallelKeyframeStyler
    with its draws: 3D (a grid-space coarse octave and a binned one, 3
    keyframes), 2D keyframes (the generic 9-tap binned splat, no views),
    the linear kernel (binned, no fallback) and a colour keyframe batch
    (the 5-channel binned pass); the parked counts agree too."""
    extra, T, shape, n, color = CASES[name]
    over = _over(vgg_path, **extra)
    frames = _frames(T, n=n, seed=len(name), shape=shape, color=color)
    kfs = keyframe_indices(T, over["particle.keyframe_stride"])
    want, want_infos = _run_jax(over, frames, shape)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, engine = _run_port(
            over, frames, shape,
            schedule=_jax_draws(over, kfs) if len(shape) == 3 else None)
    assert not any("falling back" in str(x.message) for x in w)
    _close(got, want, frames)
    assert _moved(got, frames) > 1e-6
    for kf in kfs:
        assert (engine.last_keyframe_infos[kf]["octave_overflow"]
                == [int(v) for v in want_infos[kf]["octave_overflow"]])


def test_engine_matches_independent_frames(vgg_path):
    """The engine's keyframes are the port's independent stylize_frame
    calls with the same generators (``keyframe_generator``), interpolated
    alike; ``last_keyframe_infos`` holds every keyframe's per-octave
    losses and parked counts."""
    over = _over(vgg_path)
    frames = _frames(5, seed=1)
    got, engine = _run_port(over, frames)
    styler = _styler(over)
    kfs = keyframe_indices(5, over["particle.keyframe_stride"])
    params, infos = {}, {}
    psets = _psets(frames)
    for kf in kfs:
        styler._k_cache.clear()       # independent runs
        _, params[kf], infos[kf] = styler.stylize_frame(
            psets[kf], generator=keyframe_generator(0, kf))
    want = [_numpy(t, p) for t, p in interp_sequence(
        psets, kfs, params, float(styler.cfg.particle.max_offset),
        apply_fn=styler.apply_param)]
    _close(got, want, frames)
    assert sorted(engine.last_keyframe_infos) == kfs
    for kf in kfs:
        info = engine.last_keyframe_infos[kf]
        assert len(info["octave_losses"]) == over["optim.octave_n"]
        for ls, ref in zip(info["octave_losses"], infos[kf]["octave_losses"]):
            assert ls.shape == (over["optim.iters"],)
            assert np.isfinite(ls.numpy()).all()
            np.testing.assert_allclose(ls.numpy(), ref.numpy(), rtol=1e-4)
        assert info["octave_overflow"] == infos[kf]["octave_overflow"]
    assert engine.last_collectives["all_gather"] == 0


def test_keyframe_bins_at_its_own_capacity(vgg_path):
    """ROADMAP F11: with the K-budget on, a crowded keyframe plans a
    larger bin capacity than an even one; each keyframe is binned at its
    own (the JAX engine bins both at the larger), so it parks what its
    independent stylize_frame parks and the engine yields that run's
    result, whatever keyframes run beside it."""
    over = _over(vgg_path, **{"particle.k_budget": 0.02,
                              "optim.iters": 3})
    frames = _frames(3, n=400, seed=8)
    x, d, c = frames[2]
    x = x.copy()
    x[:120] = 6.0 + 0.3 * np.random.default_rng(9).random((120, 3))
    frames[2] = (x.astype(np.float32), d, c)
    styler = _styler(over)
    plan = ParallelKeyframeStyler(styler, make_mesh(1, 1))._k_plan(
        torch.stack([torch.from_numpy(frames[k][0]) for k in (0, 2)]),
        [(8, 6, 8), SHAPE], [1])
    assert plan[0][-1] < plan[1][-1]
    got, engine = _run_port(over, frames)
    assert any(engine.last_keyframe_infos[0]["octave_overflow"])
    psets = _psets(frames)
    params = {}
    for kf in (0, 2):
        styler._k_cache.clear()
        _, params[kf], info = styler.stylize_frame(
            psets[kf], generator=keyframe_generator(0, kf))
        assert info["octave_overflow"] == \
            engine.last_keyframe_infos[kf]["octave_overflow"]
    want = [_numpy(t, p) for t, p in interp_sequence(
        psets, [0, 2], params, float(styler.cfg.particle.max_offset),
        apply_fn=styler.apply_param)]
    _close(got, want, frames)


def test_non_binned_falls_back_to_the_sequential_path(vgg_path):
    """support 1.5 cannot run binned: the engine warns "falling back" and
    yields the sequential path's result (one generator seeded with the
    seed, warm-started keyframes)."""
    over = _over(vgg_path, **{"particle.support": 1.5, "optim.iters": 2,
                              "optim.octave_n": 1})
    frames = _frames(3, n=120, seed=4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got, engine = _run_port(over, frames)
    assert any("falling back" in str(x.message) for x in w)
    styler = _styler(over)
    want = [_numpy(t, p) for t, p in styler.stylize_keyframes(
        _psets(frames), generator=torch.Generator().manual_seed(0))]
    _close(got, want, frames, rtol=0, atol=0)
    assert sorted(engine.last_keyframe_infos) == [0, 2]


def test_mesh_needs_a_frames_axis(vgg_path):
    from nfs_tpu_torch.parallel.mesh import Mesh

    bad = Mesh(shape={"x": 1}, rank=0, world=1, distributed=False,
               frame_idx=0, view_idx=0)
    with pytest.raises(ValueError, match="frames"):
        ParallelKeyframeStyler(_styler(_over(vgg_path)), bad)


# ------------------------------------------------------------------ #
# 4 gloo ranks
# ------------------------------------------------------------------ #

MESHES = [(2, 1), (4, 1), (2, 2)]


@pytest.fixture(scope="module")
def keyframe_ranks(vgg_path, tmp_path_factory):
    over = _over(vgg_path, **{"optim.iters": 3})
    frames = _frames(5, seed=5)
    runs = [dict(over=over, mesh=m, frames=frames, shape=SHAPE,
                 style=STYLE) for m in MESHES]
    out = run_ranks("keyframes", {"runs": runs}, 4,
                    tmp_path_factory.mktemp("keyframes"))
    return over, frames, out


@pytest.mark.parametrize("i", range(len(MESHES)),
                         ids=["x".join(map(str, m)) for m in MESHES])
def test_mesh_runs_match_single_mesh(keyframe_ranks, i):
    """3 keyframes on a (2, 1) mesh (padded to 4, ranks 2 and 3 left
    over), a (4, 1) mesh (padded to 4) and a (2, 2) mesh (views ranks
    repeat their shard): every rank yields the same whole sequence, the
    (1, 1) run's; the frame shards gather once, and the ranks left over
    receive one broadcast."""
    over, frames, out = keyframe_ranks
    first = out[0][i]
    for r in out[1:]:
        _close(r[i]["outs"], first["outs"], frames, rtol=0, atol=0)
    want, _ = _run_port(over, frames)
    _close(first["outs"], want, frames, rtol=MESH_RTOL,
           atol=MESH_ATOL)
    frames_axis, views = MESHES[i]
    for r, res in enumerate(out):
        c = res[i]["collectives"]
        shard = r < frames_axis * views
        assert c["all_gather"] == int(shard)
        assert c["broadcast"] == int(frames_axis * views < 4)
        assert c["all_reduce"] == c["send"] == c["recv"] == 0
