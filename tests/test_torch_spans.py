"""The program's spans (``nfs_tpu_torch.utils.profiling.span``) on the CPU.

With no profiler recording, ``span`` hands back one shared null context
and allocates nothing. Under ``torch.profiler`` each span is an operator
range of the trace, and the stylers emit them at their layer boundaries:
the streamed grid styler frame > octave > iteration > {transport, render,
features, backward, adam} with the warm start on frame 1, the particle
styler's bin plan, splats and interpolation, LNST's colour pass in a span
of its own that ``benchmark/spans.py`` gives its forward and backward
(and that a density-only keyframe never opens), and both engines on a
(1, 1) mesh their job, octaves and iterations. Recording changes no
number: the outputs and losses are bitwise those of a run without a
profiler. A Chrome trace written by ``utils.profiling.trace`` shows the
ranges.
"""

import json
import os
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spans as bench_spans
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.parallel import (
    ParallelKeyframeStyler, ParallelSequenceStyler, make_mesh)
from nfs_tpu_torch.styler.grid import GridStyler
from nfs_tpu_torch.styler.particle import ParticleStyler
from nfs_tpu_torch.utils import profiling
from nfs_tpu_torch.utils.profiling import span

torch.set_num_threads(2)

STYLE = np.random.default_rng(0).random((32, 32, 3), dtype=np.float32)
GRID = (12, 8, 12)
PGRID = (16, 12, 16)
BASE = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 4,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1",),
    "loss.style_layer_weights": (1.0,),
    "loss.w_style": 1000.0,
    "optim.lr": 0.02,
    "optim.iters": 2,
}
GRID_CFG = dict(BASE, **{"optim.octave_n": 1, "optim.window": 1})
PARTICLE_CFG = dict(BASE, **{
    "optim.octave_n": 2, "optim.lr": 0.05,
    "particle.optimize_position": True, "particle.optimize_density": True,
    "particle.keyframe_stride": 2, "particle.rebin_every": 3})
LAYERS = ("nfs.transport", "nfs.render", "nfs.features", "nfs.backward",
          "nfs.adam")


def _grid_data(T=2, seed=0):
    rng = np.random.default_rng(seed)
    ds = rng.random((T,) + GRID).astype(np.float32)
    vs = (0.5 * rng.standard_normal((T,) + GRID + (3,))).astype(np.float32)
    return ds, vs


def _psets(T=3, n=350, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.random((n, 3)) * (np.asarray(PGRID) - 4.0) + 2.0
    drift = rng.normal(size=(n, 3)) * 0.15
    return [ParticleSet(x=(x0 + t * drift).astype(np.float32),
                        dens=(0.5 + rng.random(n)).astype(np.float32))
            for t in range(T)]


def _grid_styler():
    return GridStyler(replace(StyleConfig(), **GRID_CFG), style_image=STYLE,
                      device="cpu")


def _particle_styler():
    return ParticleStyler(replace(StyleConfig(), **PARTICLE_CFG),
                          grid_shape=PGRID, style_image=STYLE, device="cpu")


def _stream():
    ds, vs = _grid_data()
    styler = _grid_styler()
    out = [(t, d.clone(), p.clone()) for t, d, p in
           styler.stylize_sequence(ds, vs, fused=0)]
    return out, [styler.frame_losses[t] for t, _, _ in out]


def _keyframes():
    styler = _particle_styler()
    out = [(t, p.x.clone(), p.dens.clone())
           for t, p in styler.stylize_keyframes(_psets())]
    return out, [torch.stack(i["octave_losses"]) for i in
                 styler.last_keyframe_infos.values()]


def _joint():
    ds, vs = _grid_data(T=3, seed=1)
    engine = ParallelSequenceStyler(_grid_styler(), make_mesh(1, 1))
    d, p, info = engine.stylize(ds, vs)
    return [d, p], info["octave_losses"]


def _engine_keyframes():
    engine = ParallelKeyframeStyler(_particle_styler(), make_mesh(1, 1))
    out = [(t, p.x.clone(), p.dens.clone())
           for t, p in engine.stylize_keyframes(_psets())]
    return out, [torch.stack(i["octave_losses"]) for i in
                 engine.last_keyframe_infos.values()]


def _recorded(run):
    """``run()`` under a CPU profiler: (its result, the nfs.* ranges as
    (name, thread, start_ns, end_ns, parent name or None), sorted)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = run()
    ranges = sorted(
        (e.start_ns(), -e.duration_ns(), e.name(), e.start_thread_id())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("nfs."))
    spans, stacks = [], {}
    for start, neg, name, thread in ranges:
        end = start - neg
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1][1] < end:
            stack.pop()
        spans.append((name, thread, start, end,
                      stack[-1][0] if stack else None))
        stack.append((name, end))
    return result, spans


def _parents(spans, name):
    return {p for n, _, _, _, p in spans if n == name}


def _same(a, b):
    """Nested lists and tuples of tensors and numbers, bitwise equal."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_span_without_a_profiler_is_one_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    assert span("nfs.render") is span("nfs.frame", {"frame": 3})
    with span("nfs.iter") as inside:
        assert inside is None
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with span("nfs.iter"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = [tracemalloc.Filter(True, profiling.__file__)]
    grown = after.filter_traces(mine).compare_to(
        before.filter_traces(mine), "filename")
    assert sum(d.count_diff for d in grown) == 0


def test_a_span_is_a_named_range_of_the_trace():
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with span("nfs.frame", {"frame": 7}):
            with span("nfs.render"):
                torch.ones(4).sum()
    got = {e.name(): e for e in prof.profiler.kineto_results.events()}
    assert got["nfs.frame"].kwinputs() == {"frame": 7}
    assert got["nfs.frame"].start_ns() <= got["nfs.render"].start_ns()
    assert got["nfs.render"].end_ns() <= got["nfs.frame"].end_ns()
    # an operator range, not a user annotation: on a GPU it adds no
    # interval to the device's timeline
    assert not got["nfs.frame"].is_user_annotation()
    assert not torch._C._autograd._profiler_enabled()


def test_streamed_grid_frames_nest_their_layers():
    (out, losses), spans = _recorded(_stream)
    names = [n for n, *_ in spans]
    assert names.count("nfs.frame") == 2
    assert _parents(spans, "nfs.octave") == {"nfs.frame"}
    assert _parents(spans, "nfs.iter") == {"nfs.octave"}
    assert names.count("nfs.iter") == 4
    for layer in LAYERS:
        assert "nfs.iter" in _parents(spans, layer), layer
    # the warm start (frame 1 only) transports the param inside its frame
    frames = [s for s in spans if s[0] == "nfs.frame"]
    warm = [s for s in spans if s[0] == "nfs.warm_start"]
    assert len(warm) == 1 and warm[0][4] == "nfs.frame"
    assert frames[1][2] <= warm[0][2] and warm[0][3] <= frames[1][3]
    assert "nfs.warm_start" in _parents(spans, "nfs.transport")
    assert _same(_stream(), (out, losses))


def test_particle_keyframes_plan_splat_and_interpolate():
    (out, losses), spans = _recorded(_keyframes)
    names = set(n for n, *_ in spans)
    assert {"nfs.frame", "nfs.octave", "nfs.iter", "nfs.splat",
            "nfs.bin_plan", "nfs.readback", "nfs.interp", "nfs.render",
            "nfs.features", "nfs.backward", "nfs.adam"} <= names
    assert _parents(spans, "nfs.octave") == {"nfs.frame"}
    assert "nfs.iter" in _parents(spans, "nfs.splat")
    assert "nfs.bin_plan" in _parents(spans, "nfs.readback")
    assert _parents(spans, "nfs.interp") == {None}
    assert _same(_keyframes(), (out, losses))


@pytest.mark.parametrize("color", [True, False], ids=["colour", "density"])
def test_the_colour_pass_is_a_span_of_its_own(color):
    """Each operator stands in for a kernel launch (as in
    ``benchmark/tests/test_benchmark_spans.py``): under ``spans.reduce``
    the colour pass's forward operators and the backward of the colour
    pass land in ``nfs.splat_color``, the innermost span around them; a
    density-only keyframe opens no such span."""
    cfg = dict(PARTICLE_CFG, **{"particle.optimize_color": color})
    styler = ParticleStyler(replace(StyleConfig(), **cfg), grid_shape=PGRID,
                            style_image=STYLE, device="cpu")
    pset = _psets(T=1)[0]
    rng = np.random.default_rng(3)
    pset = ParticleSet(x=pset.x, dens=pset.dens, color=rng.random(
        (pset.x.shape[0], 3), dtype=np.float32) if color else None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        styler.stylize_frame(pset)
    events = bench_spans.raw_events(prof)
    opened = [e for e in events if e.name == "nfs.splat_color"]
    if not color:
        assert not opened
        return
    # the finest octave's iterations, each one pass
    assert len(opened) == PARTICLE_CFG["optim.iters"]
    inside = [e for e in events if e.name.startswith("nfs.") and any(
        o.thread == e.thread and o.start < e.start <= o.end for o in opened)]
    assert not inside, "nfs.splat_color is not the innermost span"
    extra, corr, forward = [], 10 ** 9, 0
    for e in events:
        if e.name.startswith("aten::"):
            corr += 1
            extra += [bench_spans.Event("cudaLaunchKernel", False, e.start,
                                        e.start, e.thread, corr, -1, 0),
                      bench_spans.Event("stand_in", True, e.end, e.end + 1.0,
                                        0, corr, -1, 0)]
            forward += any(o.thread == e.thread and o.start <= e.start
                           <= o.end for o in opened)
    s = bench_spans.reduce(events + extra)
    assert s["launches"]["nfs.splat_color"] > forward > 0
    assert "nfs.splat_color" in s["device_s"]


@pytest.mark.parametrize("run,loss_layer", [
    (_joint, "nfs.transport"), (_engine_keyframes, "nfs.splat")],
    ids=["grid", "keyframes"])
def test_engines_on_one_rank_span_their_job(run, loss_layer):
    result, spans = _recorded(run)
    assert [n for n, *_ in spans].count("nfs.job") == 1
    assert _parents(spans, "nfs.octave") == {"nfs.job"}
    assert "nfs.octave" in _parents(spans, "nfs.iter")
    for layer in ("nfs.render", "nfs.features", "nfs.backward",
                  "nfs.adam", loss_layer):
        assert "nfs.iter" in _parents(spans, layer), layer
    assert _same(run(), result)


def test_chrome_trace_of_a_frame_shows_the_spans(tmp_path):
    ds, vs = _grid_data(T=1)
    styler = _grid_styler()
    with profiling.trace(str(tmp_path)):
        for _ in styler.stylize_sequence(ds, vs, fused=0):
            pass
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"nfs.frame", "nfs.octave", "nfs.iter", "nfs.render",
            "nfs.features", "nfs.backward", "nfs.adam",
            "nfs.transport"} <= names
