"""A sequence's octaves as CUDA graphs (``styler/octave.py``
``_OctaveGraphs``, engaged by ``styler/grid.py`` ``_sweep``) against the
eager octave loop, and the capture blockers removed from the grid path.

The tests marked ``cuda`` run ``GridStyler.stylize_sequence`` twice on the
GPU, graphed and with the graphs turned off (``GridStyler._graphed``
patched), at 24x16x24 (2D: 24x32), 2 octaves x 3 iterations, 3 views of a
6-pool, and hold every output, returned param, per-iteration loss and
final Adam state bitwise equal (the gather rotation, whose backward sums
with atomics, within tolerances). They skip without a CUDA device. This file
imports no JAX, so on a machine without it run it as
``python -m pytest --noconftest -q tests/test_torch_octave_graph.py``.

The CPU tests run the graphed path's control flow (loads, counters,
callbacks, checkpoints, resume, copies) with a recording stand-in for
``torch.cuda.graph`` whose replay calls the captured step
(``tests/torch_graph_stand_in.py``'s ``stand_in_graphs``): bitwise equal
to the eager loop once the one place where the two differ, the bias
correction's division by a Python float, is computed as CUDA computes it
(the product with its float32 reciprocal). Further CPU tests hold every
octave loop of the port to one Adam step per iteration, and
``Adam.update`` to that step written into new tensors.
"""

import os
import sys

import numpy as np
import pytest
import torch

from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.features import vgg
from nfs_tpu_torch.ops import advect_kernels as ak
from nfs_tpu_torch.parallel import make_mesh, make_sharded_window_step
from nfs_tpu_torch.styler import grid as G
from nfs_tpu_torch.styler import octave as O
from nfs_tpu_torch.styler import particle as P
from torch_graph_stand_in import stand_in_graphs  # noqa: F401 (fixture)

torch.set_num_threads(2)

SHAPE = (24, 16, 24)
T = 3
OVER = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 3,
    "render.view_pool": 6,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1", "relu2_1"),
    "loss.style_layer_weights": (1.0, 1.0),
    "loss.w_style": 1000.0,
    "loss.features_dtype": "bfloat16",
    "optim.octave_n": 2,
    "optim.octave_scale": 1.8,
    "optim.iters": 3,
    "optim.lr": 0.02,
    "optim.window": 1,
    "optim.max_disp": 2.0,
    "optim.log_every": 2,
}
CASES = {
    "density_w1": {},
    "far": {"optim.max_disp": 9.0},
    "velocity": {"optim.parameterization": "velocity"},
    "2d": {},
    "checkpoint_resume": {"optim.iters": 4},
    # a dict param: the trained transfer function
    "transfer": {"render.transfer_fn": "fire", "render.train_transfer": True},
}
# The gather rotation's backward adds into the volume with atomics
# (ops/interp.py's one index_add), so on a GPU its float32 sums come in
# another order from run to run, the eager loop's too: its graphed run is
# held to the eager one within tolerances, not bit for bit.
GATHER = {"render.rotation": "gather", "render.transfer_fn": "fire",
          "render.train_transfer": True, "loss.features_dtype": "float32"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(two_d: bool, max_disp: float):
    """(T, *shape) plume densities and (T, *shape, ndim) velocities."""
    shape = SHAPE[1:] if two_d else SHAPE
    rng = np.random.default_rng(1)
    axes = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32)
                         for n in shape], indexing="ij")
    d = np.stack([np.exp(-4 * sum((a - 0.1 * t * (i == 0)) ** 2
                                  for i, a in enumerate(axes)))
                  for t in range(T)]).astype(np.float32)
    v = (0.4 * max_disp * rng.standard_normal(
        (T,) + shape + (len(shape),))).astype(np.float32)
    return d, v


def _styler(device, graphed: bool, over):
    cfg = replace(StyleConfig(), **{**OVER, **over})
    style = np.random.default_rng(2).random((32, 32, 3), dtype=np.float32)
    s = G.GridStyler(cfg, style_image=style, device=device)
    if not graphed:
        s._graphed = lambda key, graphs, space: False
    return s


class _Record:
    """Every octave's (param, losses, Adam state) as the octave loop
    returns them, whichever runner ran it."""

    def __init__(self, monkeypatch):
        self.octaves = []
        run_octave, replay = G.run_octave, O._OctaveGraphs.replay

        def eager(*a, **k):
            return self._keep(run_octave(*a, **k))

        def graphed(graphs, *a, **k):
            return self._keep(replay(graphs, *a, **k))

        monkeypatch.setattr(G, "run_octave", eager)
        monkeypatch.setattr(O._OctaveGraphs, "replay", graphed)

    def _keep(self, out):
        param, losses, state = out
        self.octaves.append((O._clone(param), losses.clone(), state.count,
                             O._clone(state.mu), O._clone(state.nu)))
        return out


class _Stop(Exception):
    pass


def _sequence(device, graphed, case, monkeypatch, tmp_path):
    """(per frame (d_star, yielded param, losses), per octave results,
    styler) of a 3-frame sequence; the checkpoint case stops frame 2 in
    its second octave after the first chunk and resumes it on the same
    styler."""
    over = GATHER if case == "gather" else CASES[case]
    two_d = case == "2d"
    d, v = _inputs(two_d, over.get("optim.max_disp", 2.0))
    s = _styler(device, graphed, over)
    rec = _Record(monkeypatch)
    frames = []
    if case != "checkpoint_resume":
        for t, d_star, p in s.stylize_sequence(d, v, fused=0):
            frames.append((d_star.clone(), O._clone(p),
                           s.frame_losses[t].clone()))
        return frames, rec.octaves, s
    path = str(tmp_path / f"ck_{int(graphed)}.npz")
    log, stop = [], [True]

    def callback(done, loss, octave):
        log.append((octave, done, loss))
        if stop[0] and len(frames) == 2 and octave == 1 and done == 2:
            stop[0] = False
            raise _Stop

    with pytest.raises(_Stop):
        for t, d_star, p in s.stylize_sequence(
                d, v, fused=0, callback=callback, checkpoint_path=path):
            frames.append((d_star.clone(), O._clone(p),
                           s.frame_losses[t].clone()))
    assert os.path.exists(path)
    for t, d_star, p in s.stylize_sequence(
            d[2:], v, fused=0, callback=callback, checkpoint_path=path,
            init_param=frames[1][1], prev_velocity=v[1], frame_offset=2):
        frames.append((d_star.clone(), O._clone(p),
                       s.frame_losses[t].clone()))
    frames.append(log)
    return frames, rec.octaves, s


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
                    and torch.equal(a.isnan(), b.isnan()))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_sequence_bitwise_eager(cuda_device, case, monkeypatch,
                                        tmp_path):
    """Output densities, yielded params, per-iteration losses (and a
    resumed run's callback losses) and every octave's returned param,
    losses and final Adam state: the graphed sequence's equal the eager
    loop's bit for bit; frames 1 and 2 replay. The hand kernels' launch
    counters count the same launches on both runs."""
    before = dict(ak.LAUNCHES)
    eager, eager_oct, _ = _sequence(cuda_device, False, case, monkeypatch,
                                    tmp_path)
    monkeypatch.undo()
    eager_launches = {k: n - before[k] for k, n in ak.LAUNCHES.items()}
    before = dict(ak.LAUNCHES)
    got, got_oct, s = _sequence(cuda_device, True, case, monkeypatch,
                                tmp_path)
    assert s._graphs.captures == 2
    assert s._graphs.replays > 0
    assert {k: n - before[k] for k, n in ak.LAUNCHES.items()} == \
        eager_launches
    assert len(got) == len(eager) and len(got_oct) == len(eager_oct)
    for t, (a, b) in enumerate(zip(eager, got)):
        assert _equal(a, b), f"frame {t} differs"
    for o, (a, b) in enumerate(zip(eager_oct, got_oct)):
        assert _equal(a, b), f"octave run {o} differs"


def _max_gaps(a, b):
    """Largest gaps of (d_star, param, losses relative) over the frames."""
    gaps = [0.0, 0.0, 0.0]
    for (d0, p0, l0), (d1, p1, l1) in zip(a, b):
        gaps[0] = max(gaps[0], float((d1 - d0).abs().max()))
        gaps[1] = max(gaps[1], max(float((p1[k] - p0[k]).abs().max())
                                   for k in p0))
        gaps[2] = max(gaps[2], float(((l1 - l0) / l0).abs().max()))
    return gaps


@pytest.mark.cuda
def test_graphed_gather_rotation_near_eager(cuda_device, monkeypatch,
                                           tmp_path):
    """The gather rotation (with the trained transfer function) captures
    its octaves and replays them, launches what the eager loop launches,
    and its frames stay within the tolerances chip_smoke.py holds this
    path to against the CPU (1e-3 absolute in d_star and the param, 1e-4
    relative in the losses). On an H100 two eager runs differ by up to
    4.7e-6 in d_star and the param, and the graphed run from an eager one
    by up to 2.8e-5; the losses by 8.6e-8 relative in both."""
    runs = []
    for graphed in (False, True):
        before = dict(ak.LAUNCHES)
        frames, _, s = _sequence(cuda_device, graphed, "gather",
                                 monkeypatch, tmp_path)
        monkeypatch.undo()
        runs.append((frames, {k: n - before[k]
                              for k, n in ak.LAUNCHES.items()}))
    assert (s._graphs.captures, s._graphs.replays) == (2, 12)
    assert runs[0][1] == runs[1][1]
    gaps = _max_gaps(runs[0][0], runs[1][0])
    assert all(g <= t for g, t in zip(gaps, (1e-3, 1e-3, 1e-4))), gaps


@pytest.mark.cuda
def test_one_capture_per_key(cuda_device):
    """Three frames capture each octave's key once (in frame 1), then
    replay: 2 keys, 2 captures, 2 octaves x 3 iterations x 2 frames of
    replays; a second sequence on the styler replays from its first frame
    and captures nothing."""
    d, v = _inputs(False, 2.0)
    s = _styler(cuda_device, True, {})
    for _ in s.stylize_sequence(d, v, fused=0):
        pass
    assert (s._graphs.captures, s._graphs.replays) == (2, 12)
    assert len(s._graphs._graphs) == 2
    for _ in s.stylize_sequence(d, v, fused=0):
        pass
    assert (s._graphs.captures, s._graphs.replays) == (2, 30)


@pytest.mark.cuda
def test_replayed_octave_does_not_sync(cuda_device, monkeypatch):
    """An octave whose graph exists (copies in, replays, copies out)
    makes no synchronizing call: torch's sync debug mode raises on one."""
    d, v = _inputs(False, 2.0)
    s = _styler(cuda_device, True, {})
    checked = []

    def strict(name):
        real = getattr(O._OctaveGraphs, name)

        def call(graphs, key, *a, **k):
            if key not in graphs._graphs:
                return real(graphs, key, *a, **k)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = real(graphs, key, *a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            checked.append(name)
            return out
        return call

    for name in ("load", "replay"):
        monkeypatch.setattr(O._OctaveGraphs, name, strict(name))
    for _ in s.stylize_sequence(d, v, fused=0):
        pass
    # frame 2's octaves
    assert checked.count("load") == checked.count("replay") == 2


@pytest.mark.cuda
def test_yielded_param_is_not_a_static_buffer(cuda_device):
    """The param yielded for frame t, and its losses, stay as they were
    while frame t + 1 replays the same graphs."""
    d, v = _inputs(False, 2.0)
    s = _styler(cuda_device, True, {})
    held = []
    for t, d_star, p in s.stylize_sequence(d, v, fused=0):
        if held:
            kept, copy, losses, copy_losses = held[-1]
            assert torch.equal(kept, copy)
            assert torch.equal(losses, copy_losses)
        held.append((p, p.clone(), s.frame_losses[t],
                     s.frame_losses[t].clone()))
    assert s._graphs.replays == 12


# ---------------------------------------------------------------------- #
# CPU
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_preprocess_values_and_no_tensor_built_again(dtype, monkeypatch):
    """preprocess gives what it gave when it built the ImageNet mean and
    std on every call, bit for bit, and builds no tensor on a second
    call (on a GPU that build is a host copy: a sync, and no capture)."""
    imgs = torch.rand((2, 8, 8, 3), generator=torch.Generator().manual_seed(
        0)).to(dtype)
    mean = torch.tensor(vgg._IMAGENET_MEAN, dtype=dtype)
    std = torch.tensor(vgg._IMAGENET_STD, dtype=dtype)
    want = (imgs - mean) / std
    assert torch.equal(vgg.preprocess(imgs), want)

    def no_build(*a, **k):
        raise AssertionError("preprocess built a tensor")

    monkeypatch.setattr(torch, "tensor", no_build)
    assert torch.equal(vgg.preprocess(imgs), want)


def test_vel_grad_chain_values(monkeypatch):
    """vel_grad_chain equals its formula with the grid's last cells built
    on the call, for one displacement and a batch, and builds no tensor
    from the host on a second call."""
    rng = np.random.default_rng(3)
    shape = (5, 4, 6)
    for lead in ((), (2,)):
        g = torch.from_numpy(rng.standard_normal(lead + shape + (3,),
                                                 dtype=np.float32))
        v = torch.from_numpy(2.5 * rng.standard_normal(
            lead + shape + (3,), dtype=np.float32))
        idx = torch.stack(torch.broadcast_tensors(*ak._axes(shape, "cpu")),
                          dim=-1)
        sizes = torch.tensor([s - 1 for s in shape], dtype=torch.float32)
        want = (-g * ak._clip_grad(idx - v.clamp(-2.0, 2.0), 0.0, sizes)
                * ak._clip_grad(v, -2.0, 2.0))
        assert torch.equal(ak.vel_grad_chain(g, v, 2.0), want)
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: 1 / 0)
    assert torch.equal(ak.vel_grad_chain(g, v, 2.0), want)


def test_rotate3d_batch_values_and_no_tensor_built_again(monkeypatch):
    """The gather rotation gives what it gave when it built the volume's
    centre on every call, and builds no tensor on a second call (on a
    GPU that build is a host copy: a sync, and no capture)."""
    from nfs_tpu_torch.ops import rotate
    d = torch.rand((6, 5, 7), generator=torch.Generator().manual_seed(0))
    th, ph = torch.tensor([0.1, -0.2]), torch.tensor([0.05, 0.0])
    center = torch.tensor([2.5, 2.0, 3.0])
    r = rotate.rotation_matrix(th, ph)
    coords = rotate.identity_coords((6, 5, 7), device="cpu") - center
    want = rotate.grid_sample(d, coords[None] @ r[:, None, None] + center,
                              mode="zero")
    assert torch.equal(rotate.rotate3d_batch(d, th, ph), want)
    monkeypatch.setattr(torch, "tensor", lambda *a, **k: 1 / 0)
    assert torch.equal(rotate.rotate3d_batch(d, th, ph), want)


def test_cpu_sequence_never_captures():
    """On the CPU a sequence runs every octave eagerly: no graph, no
    capture, no replay, and a key it has run eagerly is still not
    graphed."""
    over = {**OVER, "render.render_size": (16, 16), "optim.iters": 2}
    cfg = replace(StyleConfig(), **over)
    style = np.random.default_rng(2).random((16, 16, 3), dtype=np.float32)
    s = G.GridStyler(cfg, style_image=style, device="cpu")
    d, v = _inputs(False, 2.0)
    d, v = d[:, ::2, ::2, ::2], v[:, ::2, ::2, ::2]
    for _ in s.stylize_sequence(np.ascontiguousarray(d),
                                np.ascontiguousarray(v), fused=0):
        pass
    assert (s._graphs.captures, s._graphs.replays) == (0, 0)
    assert not s._graphs._graphs
    assert not s._graphed(next(iter(s._graphs._eager)), True, G._one_slab())


@pytest.mark.parametrize("case", ["density_w1", "checkpoint_resume",
                                  "gather"])
def test_graphed_control_flow_on_cpu(stand_in_graphs, case, monkeypatch,
                                     tmp_path):
    """The graphed path's loads, counters, chunk callbacks, checkpoints,
    resume and copies out, with a stand-in graph on the CPU at 12x8x12:
    bitwise the eager loop, the one Adam formula under CUDA's division
    in the bias correction."""
    monkeypatch.setattr(sys.modules[__name__], "SHAPE", (12, 8, 12))
    eager, eager_oct, _ = _sequence("cpu", False, case, monkeypatch,
                                    tmp_path)
    got, got_oct, s = _sequence("cpu", True, case, monkeypatch, tmp_path)
    assert s._graphs.captures == 2
    assert s._graphs.replays == (16 if case == "checkpoint_resume" else 12)
    for a, b in zip(eager + eager_oct, got + got_oct):
        assert _equal(a, b)


def test_capture_and_replay_spans_on_cpu(stand_in_graphs, monkeypatch):
    """Under the profiler a capture is an ``nfs.capture`` range in its
    octave and each replay an ``nfs.replay`` range inside an
    ``nfs.iter``, so the spans count how often the graphs engage."""
    monkeypatch.setattr(sys.modules[__name__], "SHAPE", (12, 8, 12))
    d, v = _inputs(False, 2.0)
    s = _styler("cpu", True, {})
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in s.stylize_sequence(d, v, fused=0):
            pass
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("nfs.")]
    names = [n for n, _, _ in spans]

    def inside(outer):
        return [n for n, s0, e0 in spans if any(
            o == outer and s1 <= s0 and e0 <= e1 for o, s1, e1 in spans)]

    assert names.count("nfs.capture") == 2
    assert names.count("nfs.replay") == 12
    assert names.count("nfs.iter") == 6 + 12
    assert inside("nfs.octave").count("nfs.capture") == 2
    assert inside("nfs.iter").count("nfs.replay") == 12


def test_launches_count_replays_on_cpu(stand_in_graphs, monkeypatch,
                                       tmp_path):
    """A capture's launches are taken back out of the hand kernels'
    counters, and each replay adds them, also the replays of an octave a
    callback stops: with a stand-in capture that counts 3 launches, the
    counters rise by 3 a replay."""
    monkeypatch.setattr(sys.modules[__name__], "SHAPE", (12, 8, 12))
    recorded = O._OctaveGraph.step

    def counting(self, loss_fn, optimizer):
        if stand_in_graphs.capturing is not None:
            ak.LAUNCHES["fwd"] += 3
        return recorded(self, loss_fn, optimizer)

    monkeypatch.setattr(O._OctaveGraph, "step", counting)
    before = ak.LAUNCHES["fwd"]
    _, _, s = _sequence("cpu", True, "checkpoint_resume", monkeypatch,
                        tmp_path)
    assert s._graphs.replays == 16
    assert ak.LAUNCHES["fwd"] - before == 3 * 16


def test_capture_with_another_object_raises_on_cpu(stand_in_graphs,
                                                   monkeypatch):
    """An entry of the octave's data that is not copied in at each octave
    (the VGG weights here) must be the object the graph was captured
    with: a replay on another raises rather than read stale tensors."""
    monkeypatch.setattr(sys.modules[__name__], "SHAPE", (12, 8, 12))
    d, v = _inputs(False, 2.0)
    s = _styler("cpu", True, {})
    for _ in s.stylize_sequence(d[:2], v[:2], fused=0):
        pass
    assert s._graphs.captures == 2
    s.vgg_params = dict(s.vgg_params)
    with pytest.raises(ValueError, match="vgg"):
        for _ in s.stylize_sequence(d[:2], v[:2], fused=0):
            pass


def test_new_shape_drops_graphs_on_cpu(stand_in_graphs, monkeypatch):
    """A styler holds the graphs of one frame shape: a sequence at another
    shape starts afresh (its first frame eager, the next capturing), and
    coming back to the first shape captures again."""
    monkeypatch.setattr(sys.modules[__name__], "SHAPE", (12, 8, 12))
    d, v = _inputs(False, 2.0)
    s = _styler("cpu", True, {})
    shapes = []
    for dd, vv in ((d, v), (d[:, :8], v[:, :8]), (d, v)):
        graphs = s._graphs
        for _ in s.stylize_sequence(np.ascontiguousarray(dd),
                                    np.ascontiguousarray(vv), fused=0):
            pass
        assert s._graphs is not graphs
        assert (s._graphs.captures, s._graphs.replays) == (2, 12)
        shapes.append({k[0] for k in s._graphs._graphs})
    assert shapes[0] == shapes[2] and not shapes[0] & shapes[1]


def test_failed_capture_raises_on_cpu(stand_in_graphs, monkeypatch):
    """A capture that fails raises, and leaves no graph and the launch
    counters as they were: there is no eager fallback to hide it."""
    monkeypatch.setattr(sys.modules[__name__], "SHAPE", (12, 8, 12))
    recorded = O._OctaveGraph.step

    def failing(self, loss_fn, optimizer):
        if stand_in_graphs.capturing is not None:
            ak.LAUNCHES["fwd"] += 3
            raise RuntimeError("operation not permitted when capturing")
        return recorded(self, loss_fn, optimizer)

    monkeypatch.setattr(O._OctaveGraph, "step", failing)
    d, v = _inputs(False, 2.0)
    s = _styler("cpu", True, {})
    before = dict(ak.LAUNCHES)
    with pytest.raises(RuntimeError, match="capturing"):
        for _ in s.stylize_sequence(d, v, fused=0):
            pass
    assert not s._graphs._graphs and s._graphs.captures == 0
    assert ak.LAUNCHES == before


# ---------------------------------------------------------------------- #
# one Adam formula (CPU)
# ---------------------------------------------------------------------- #

PGRID = (12, 10, 12)
POVER = {
    "render.render_size": (16, 16),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 2,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1",),
    "loss.style_layer_weights": (1.0,),
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.05,
    "particle.rebin_every": 2,
}
# a particle frame's loop: (config, the function the loop runs in, its
# calls); 2 octaves x 3 iterations, rebinned every 2 in the binned route
PARTICLE_LOOPS = {
    "binned_chunk": ({}, (P, "_binned_chunk_core"), 4),
    "grid_coarse": ({"particle.optimize_density": True},
                    (P.ParticleStyler, "_grid_coarse_octave"), 1),
    "flat_particle": ({"particle.splat_impl": "flat"},
                      (P, "_binned_chunk_core"), 0),
}


def _calls(monkeypatch, owner, name) -> list:
    """The calls of ``owner.name`` from here on (patched to count)."""
    calls, real = [], getattr(owner, name)

    def counted(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("loop", ["grid_eager", "graphed_stand_in"]
                         + sorted(PARTICLE_LOOPS) + ["sharded_window"])
def test_one_adam_step_per_iteration(loop, request, monkeypatch):
    """Every octave loop of the port takes its step from the one Adam
    formula, once per iteration: the grid styler's eager octaves and its
    replays (a stand-in graph), the binned particle chunk, the grid-space
    coarse octave, the flat particle octave and the sharded window step.
    Each loop is seen to run: the function it runs in is called."""
    monkeypatch.setattr(sys.modules[__name__], "SHAPE", (12, 8, 12))
    graphed = loop == "graphed_stand_in"
    if graphed:
        request.getfixturevalue("stand_in_graphs")
    steps = _calls(monkeypatch, O.Adam, "_step")
    if loop in ("grid_eager", "graphed_stand_in"):
        runs = _calls(monkeypatch, G, "run_octave")
        s = _styler("cpu", graphed, {})
        d, v = _inputs(False, 2.0)
        for _ in s.stylize_sequence(d, v, fused=0):
            pass
        # the first frame's 2 octaves run eagerly, warming the graphs up
        assert (len(runs), s._graphs.replays) == ((2, 12) if graphed
                                                  else (6, 0))
        assert len(steps) == T * 2 * 3
    elif loop == "sharded_window":
        opt = O.Adam(0.05)
        step = make_sharded_window_step(
            make_mesh(1, 1), lambda p, d, *_: ((d + p) ** 2).sum(), opt,
            window=0, n_views=1, n_iters=3)
        params = torch.zeros((2, 4, 5))
        out, _, losses = step(params, opt.init(params), torch.rand((2, 4, 5)),
                              None, None, None, None)
        assert losses.shape == (3,) and not torch.equal(out, params)
        assert len(steps) == 3
    else:
        over, (owner, name), n = PARTICLE_LOOPS[loop]
        runs = _calls(monkeypatch, owner, name)
        cfg = replace(StyleConfig(), **{**POVER, **over})
        style = np.random.default_rng(2).random((16, 16, 3),
                                                dtype=np.float32)
        s = P.ParticleStyler(cfg, PGRID, style_image=style, device="cpu")
        rng = np.random.default_rng(0)
        x = rng.random((300, 3)) * (np.array(PGRID) - 4) + 2
        s.stylize_frame(ParticleSet(x=x.astype(np.float32),
                                    dens=np.ones(300, np.float32)))
        assert len(runs) == n
        assert len(steps) == 2 * 3


@pytest.mark.parametrize("kind", ["tensor", "dict"])
def test_adam_update_is_the_step_into_new_tensors(kind):
    """``Adam.update`` leaves the gradient and the state it is given as
    they were, and its step and new moments are, bit for bit, what the
    one formula writes in place (as a graph does) from that state."""
    gen = torch.Generator().manual_seed(0)

    def tree(draw):
        t = {"a": draw((5, 3), generator=gen), "b": draw((4,), generator=gen)}
        return t if kind == "dict" else t["a"]

    grad, mu, nu = tree(torch.randn), tree(torch.randn), tree(torch.rand)
    kept = [O._clone(t) for t in (grad, mu, nu)]
    opt = O.Adam(0.05)
    step, new = opt.update(grad, O.AdamState(6, mu, nu))
    assert _equal([grad, mu, nu], kept)
    assert new.count == 7
    ptrs = [t.data_ptr() for tree in (mu, nu, new.mu, new.nu)
            for t in (tree.values() if kind == "dict" else [tree])]
    assert len(set(ptrs)) == len(ptrs)
    mu_in, nu_in = O._clone(mu), O._clone(nu)
    in_place = opt._step(grad, mu_in, nu_in, mu_in, nu_in,
                         *opt._corrections(7))
    assert _equal(step, in_place)
    assert _equal([new.mu, new.nu], [mu_in, nu_in])
