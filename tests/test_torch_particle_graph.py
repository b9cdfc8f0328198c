"""An LNST keyframe sequence's octaves as CUDA graphs
(``styler/particle.py`` ``ParticleStyler._graphed``, through
``styler/octave.py`` ``_OctaveGraphs``) against the eager octave loop.

In ``stylize_keyframes`` on a GPU, each grid-space coarse octave and each
density-only binned chunk replays its Adam iteration as a CUDA graph once
the styler has run its key eagerly (the first keyframe); ``stylize_frame``
alone, the keyframe-parallel engine and the colour route's binned octave
stay eager.

The tests marked ``cuda`` run a 3-keyframe sequence graphed and with the
graphs turned off (``ParticleStyler._graphed`` patched), density-only, with
colour, and across a change of the bin plan's K, and hold the keyframe
params, per-octave losses, parked counts and every output frame bitwise
equal. They skip without a CUDA device. This file imports no JAX, so on a
machine without it run it as ``python -m pytest --noconftest -q
tests/test_torch_particle_graph.py``.

The CPU tests run the graphed path's control flow with
``tests/torch_graph_stand_in.py``'s ``stand_in_graphs`` (a stand-in for
``torch.cuda.graph`` whose replay calls the captured step; the bias
correction computed as CUDA computes it), at a size the CPU holds.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.ops import binsplat_kernels as bk
from nfs_tpu_torch.parallel import ParallelKeyframeStyler, make_mesh
from nfs_tpu_torch.styler import octave as O
from nfs_tpu_torch.styler import particle as P
from torch_graph_stand_in import stand_in_graphs  # noqa: F401 (fixture)

torch.set_num_threads(2)

FRAMES = 9      # keyframe stride 4: keyframes 0, 4 and 8
OVER = {
    "render.render_size": (16, 16),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 4,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1",),
    "loss.style_layer_weights": (1.0,),
    "loss.w_style": 1000.0,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.05,
    "particle.optimize_position": True,
    "particle.optimize_density": True,
    "particle.coarse_mode": "grid",
    "particle.keyframe_stride": 4,
    "particle.rebin_every": 2,
}
# the card's size: two coarse octaves, renders through the shear kernels
# at 32^2, the binned splat through K4/K5 (K4c/K5c with colour)
CUDA_OVER = {"render.render_size": (32, 32), "render.n_views": 3,
             "render.view_pool": 6, "loss.style_layers": ("relu1_1",
                                                           "relu2_1"),
             "loss.style_layer_weights": (1.0, 1.0), "optim.octave_n": 3,
             "optim.octave_scale": 1.8}
CASES = {"density": {}, "color": {"particle.optimize_color": True},
         # the generic binned pass, not the window kernels
         "generic": {"particle.splat_impl": "binned"}}


@pytest.fixture
def cuda_device(monkeypatch):
    """The card, with cuDNN's deterministic convolutions: at these small
    renders its default algorithms do not repeat an eager run's bits
    (two eager runs' offsets differ by up to 3e-4 on an H100), while at
    the cells' 256^2 they do, graphed or not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda", 0)


def _frames(grid, n):
    """FRAMES particle sets (positions turning about the box's centre,
    densities, colours) with stable identity."""
    rng = np.random.default_rng(0)
    g = np.asarray(grid, np.float32)
    x0 = rng.random((n, 3), dtype=np.float32) * (g - 6) + 3
    colour = rng.random((n, 3), dtype=np.float32)
    dens = (0.5 + rng.random(n, dtype=np.float32)).astype(np.float32)
    c = g / 2
    out = []
    for t in range(FRAMES):
        a = 0.03 * t
        r = x0 - c
        x = np.stack([r[:, 0], np.cos(a) * r[:, 1] - np.sin(a) * r[:, 2],
                      np.sin(a) * r[:, 1] + np.cos(a) * r[:, 2]], -1) + c
        out.append(ParticleSet(x=x.astype(np.float32), dens=dens,
                               color=colour))
    return out


def _styler(device, graphed: bool, over, grid=(12, 10, 12)):
    cfg = replace(StyleConfig(), **{**OVER, **over})
    style = np.random.default_rng(2).random((32, 32, 3), dtype=np.float32)
    s = P.ParticleStyler(cfg, grid, style_image=style, device=device)
    if not graphed:
        s._graphed = lambda key: False
    return s


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return [_clone(v) for v in tree]


class _Record:
    """Every keyframe batch's (param, per-octave losses, parked counts) as
    ``_optimize_keyframes`` returns them, cloned, and the returned objects
    themselves (``kept``)."""

    def __init__(self, monkeypatch):
        self.batches, self.kept = [], []
        optimize = P.ParticleStyler._optimize_keyframes

        def recorded(styler, *a, **k):
            out = optimize(styler, *a, **k)
            self.batches.append(_clone(list(out)))
            self.kept.append(out)
            return out

        monkeypatch.setattr(P.ParticleStyler, "_optimize_keyframes",
                            recorded)


def _run(s, psets):
    """Every yielded frame's (x, dens, colour), cloned."""
    return [(t, ps.x.clone(), ps.dens.clone(),
             None if ps.color is None else torch.as_tensor(ps.color).clone())
            for t, ps in s.stylize_keyframes(psets)]


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _bump_plan(s, by: int = 2):
    """Every cached bin plan's K raised by ``by``: the next keyframe runs
    its binned octaves in another layout."""
    for sig, ks in s._k_cache.items():
        s._k_cache[sig] = [None if k is None else k + by for k in ks]


def _sequences(device, graphed, case, n_seq=1, k_change=False,
               grid=(12, 10, 12), n=400, over=None):
    """(yielded frames, keyframe batches, styler) of ``n_seq`` sequences
    on one styler; with ``k_change`` every later sequence's plan has K + 2
    at every octave."""
    s = _styler(device, graphed, {**CASES[case], **(over or {})}, grid)
    psets = _frames(grid, n)
    frames = []
    with pytest.MonkeyPatch.context() as mp:
        rec = _Record(mp)
        for i in range(n_seq):
            if k_change and i:
                _bump_plan(s)
            frames.append(_run(s, psets))
    return frames, rec.batches, s


def _binned_ks(s) -> set:
    return {k[2] for k in s._graphs._graphs if k[0] == "binned"}


# ---------------------------------------------------------------------- #
# CUDA
# ---------------------------------------------------------------------- #


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["density", "color", "k_change"])
def test_graphed_keyframes_bitwise_eager(cuda_device, case, monkeypatch):
    """Keyframe params, per-octave losses, parked counts and every output
    frame: the graphed sequence's equal the eager loop's bit for bit, for
    density alone, with colour (its coarse octaves graphed, its binned
    octave eager) and across a plan whose K changes between two
    sequences. Keyframes 4 and 8 replay; the binned kernels count the
    same launches on both runs."""
    k_change = case == "k_change"
    args = dict(n_seq=2 if k_change else 1, k_change=k_change,
                grid=(24, 16, 24), n=3000, over=CUDA_OVER)
    case = "density" if k_change else case
    runs = []
    for graphed in (False, True):
        before = dict(bk.LAUNCHES)
        frames, batches, s = _sequences(cuda_device, graphed, case,
                                        **args)
        runs.append((frames, batches, {k: n - before[k]
                                       for k, n in bk.LAUNCHES.items()}))
    assert s._graphs.replays > 0
    if case == "color":
        assert not _binned_ks(s)
    assert runs[0][2] == runs[1][2]
    assert len(runs[0][1]) == len(runs[1][1]) == 3 * args["n_seq"]
    for i, (a, b) in enumerate(zip(runs[0][1], runs[1][1])):
        assert _equal(a, b), f"keyframe batch {i} differs"
    assert _equal(runs[0][0], runs[1][0])


@pytest.mark.cuda
def test_replayed_keyframe_octave_does_not_sync(cuda_device, monkeypatch):
    """An octave or binned chunk whose graph exists (copies in, replays,
    copies out) makes no synchronizing call: torch's sync debug mode
    raises on one."""
    s = _styler(cuda_device, True, CUDA_OVER, (24, 16, 24))
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
    _run(s, _frames((24, 16, 24), 3000))
    # keyframe 8: two coarse octaves, two binned chunks
    assert checked.count("replay") == 4 and checked.count("load") == 4


@pytest.mark.cuda
def test_yielded_keyframe_param_is_not_a_static_buffer(cuda_device,
                                                       monkeypatch):
    """Each keyframe's param, losses and parked counts, as the octave loop
    hands them on, stay as they were while the later keyframes replay the
    same graphs."""
    rec = _Record(monkeypatch)
    s = _styler(cuda_device, True, CUDA_OVER, (24, 16, 24))
    _run(s, _frames((24, 16, 24), 3000))
    assert s._graphs.replays > 0
    assert _equal([list(k) for k in rec.kept], rec.batches)


# ---------------------------------------------------------------------- #
# CPU
# ---------------------------------------------------------------------- #


@pytest.mark.parametrize("case", sorted(CASES))
def test_first_keyframe_eager_then_capture_and_replay_on_cpu(
        stand_in_graphs, case, monkeypatch):
    """Keyframe 0 runs every octave eagerly, keyframe 4 captures each key
    once (the coarse octave's; through the window kernels without colour
    also the binned chunks of 2 and 1 iterations) and keyframe 8 replays
    them; the colour route's binned octave and the generic binned pass
    never capture. Bitwise the eager loop. A second sequence on the
    styler replays from its first keyframe and captures nothing."""
    eager, eager_b, _ = _sequences("cpu", False, case)
    got, got_b, s = _sequences("cpu", True, case, n_seq=2)
    binned = case == "density"
    per_kf = 3 + 2 + 1 if binned else 3
    assert s._graphs.captures == (3 if binned else 1)
    assert s._graphs.captures == len(s._graphs._graphs)
    assert s._graphs.replays == 2 * per_kf + 3 * per_kf
    assert {k[0] for k in s._graphs._graphs} == (
        {"coarse", "binned"} if binned else {"coarse"})
    assert _equal(eager_b, got_b[:3]) and _equal(eager[0], got[0])


def test_stylize_frame_alone_never_captures_on_cpu(stand_in_graphs):
    """``stylize_frame`` called alone runs eagerly, also once its keys are
    warm."""
    s = _styler("cpu", True, {})
    for ps in _frames((12, 10, 12), 400)[:3]:
        s.stylize_frame(ps)
    assert s._graphs._eager
    assert (s._graphs.captures, s._graphs.replays) == (0, 0)


def test_keyframe_engine_never_captures_on_cpu(stand_in_graphs):
    """The keyframe-parallel engine runs its batch through the same octave
    loop eagerly, also on a styler whose sequence keys are warm."""
    s = _styler("cpu", True, {})
    psets = _frames((12, 10, 12), 400)
    _run(s, psets)
    captures, replays = s._graphs.captures, s._graphs.replays
    eng = ParallelKeyframeStyler(s, make_mesh(1, 1))
    for _ in eng.stylize_keyframes(psets):
        pass
    assert (s._graphs.captures, s._graphs.replays) == (captures, replays)
    assert not s._in_sequence


def test_new_k_drops_old_finest_graph_on_cpu(stand_in_graphs, monkeypatch):
    """A plan whose K changes drops the old layout's binned graphs before
    the octave runs (eagerly, its key new), so one layout's graphs are
    alive at a time; the next keyframe captures the new layout. Bitwise
    the eager loop across the change."""
    held = []
    core = P._binned_chunk_core

    def watched(*a, **k):
        held.append(_binned_ks(s))
        return core(*a, **k)

    eager, eager_b, _ = _sequences("cpu", False, "density", n_seq=2,
                                   k_change=True)
    s = _styler("cpu", True, {})
    monkeypatch.setattr(P, "_binned_chunk_core", watched)
    psets = _frames((12, 10, 12), 400)
    rec = _Record(monkeypatch)
    first = _run(s, psets)
    (k0,) = _binned_ks(s)
    _bump_plan(s)
    second = _run(s, psets)
    # sequence 2, keyframe 0: eager at K + 2 with the old graphs gone
    assert held[6] == set() and _binned_ks(s) == {k0 + 2}
    assert s._graphs.captures == 3 + 2
    assert _equal(eager_b, rec.batches) and _equal(eager, [first, second])


def test_data_entry_not_moved_raises_on_cpu(stand_in_graphs):
    """An entry of a graphed octave's data that is not copied in (the VGG
    weights here) must be the object the graph was captured with: a
    replay on another raises rather than read stale tensors."""
    s = _styler("cpu", True, {})
    psets = _frames((12, 10, 12), 400)
    _run(s, psets)
    assert s._graphs.captures == 3
    s.vgg_params = dict(s.vgg_params)
    with pytest.raises(ValueError, match="vgg"):
        _run(s, psets)


def test_binsplat_launches_count_replays_on_cpu(stand_in_graphs,
                                                monkeypatch):
    """The binned kernels' launch counters count what the card launches:
    a capture's launches (here K4 and K5 once a binned iteration, as the
    card records them) are taken back out, and each replay adds them, so
    a graphed sequence counts what the eager one does."""
    replaying = []

    def counted(name, real):
        def launch(*a):
            if not replaying:
                bk.LAUNCHES[name] += 1
            return real(*a)
        return launch

    monkeypatch.setattr(bk, "binsplat_fwd", counted("fwd", bk.binsplat_fwd))
    monkeypatch.setattr(bk, "binsplat_bwd", counted("bwd", bk.binsplat_bwd))
    replay = stand_in_graphs.replay

    def replayed(graph):
        replaying.append(graph)
        try:
            replay(graph)
        finally:
            replaying.pop()

    monkeypatch.setattr(stand_in_graphs, "replay", replayed)
    step = O._OctaveGraph.step

    def capturing(g, loss_fn, optimizer):
        if stand_in_graphs.capturing is not None and "xb" in g.moved:
            bk.LAUNCHES["fwd"] += 1
            bk.LAUNCHES["bwd"] += 1
        return step(g, loss_fn, optimizer)

    monkeypatch.setattr(O._OctaveGraph, "step", capturing)
    counts = []
    for graphed in (False, True):
        before = dict(bk.LAUNCHES)
        s = _styler("cpu", graphed, {})
        _run(s, _frames((12, 10, 12), 400))
        counts.append({k: bk.LAUNCHES[k] - before[k] for k in before})
    assert s._graphs.replays == 2 * 6
    # 3 keyframes x 3 binned iterations; K4 also at each coarse splat
    assert counts[0]["bwd"] == 9 and counts[0]["fwd"] == 9 + 3
    assert counts[0] == counts[1]


def test_replayed_iteration_builds_no_host_tensor_on_cpu(stand_in_graphs,
                                                         monkeypatch):
    """A replayed coarse or binned iteration builds no tensor from host
    data and reads nothing back to the host (on a GPU either is a sync,
    which a capture refuses)."""
    replay = stand_in_graphs.replay
    host = [(torch, "tensor"), (torch, "from_numpy"),
            (torch.Tensor, "item"), (torch.Tensor, "cpu"),
            (torch.Tensor, "tolist"), (torch.Tensor, "numpy")]

    def refused(name):
        def call(*a, **k):
            raise AssertionError(f"{name} in a replayed iteration")
        return call

    def strict(graph):
        with pytest.MonkeyPatch.context() as mp:
            for owner, name in host:
                mp.setattr(owner, name, refused(name))
            replay(graph)

    monkeypatch.setattr(stand_in_graphs, "replay", strict)
    s = _styler("cpu", True, {})
    _run(s, _frames((12, 10, 12), 400))
    assert s._graphs.replays == 2 * 6


def test_dropped_styler_is_freed_at_once_on_cpu(stand_in_graphs):
    """A styler that ran a graphed sequence is freed, its graphs' buffers
    with it, as soon as it is dropped, without the garbage collector: its
    cached loss closures hold it weakly."""
    s = _styler("cpu", True, {})
    _run(s, _frames((12, 10, 12), 400))
    assert s._graphs.captures == 3
    ref = weakref.ref(s)
    buffers = weakref.ref(next(g for k, g in s._graphs._graphs.items()
                               if k[0] == "binned").param["dx"])
    enabled = gc.isenabled()
    gc.disable()
    try:
        del s
        assert ref() is None and buffers() is None
    finally:
        if enabled:
            gc.enable()
