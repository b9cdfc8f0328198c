"""A whole run of every cell without the look for a card: a sound run
comes out correct, and a run with the timed path broken underneath comes
out not correct (``harness.result`` decides), once for each fault the
cells can have: a step that returns its state unchanged, half of the
batch left out with the mean taken over the rest, and an answer altered
where it is produced. (One card, so no exchange between cards to leave
out.) At a size the CPU holds; at the cells' own size on the card
(marker ``cuda``), or, to print the readings of some seeds:

    python3 benchmark/tests/test_benchmark_faults.py <cell>... <seed>...
"""

import copy
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def tiny(cell_name: str):
    cell = copy.deepcopy(harness.load_cell(cell_name))
    cell.config["grid"] = [16, 12, 16]
    cell.config["style_config"].update({
        "render.render_size": [32, 32], "render.n_views": 4,
        "render.view_pool": 6, "optim.iters": 3, "optim.octave_n": 2,
        "loss.style_layers": ["relu1_1", "relu2_1"],
        "loss.style_layer_weights": [1.0, 1.0]})
    if "particles" in cell.config:
        cell.config["particles"] = 3000
        cell.config["data"].update({"box_lo": [2.0, 2.0, 2.0],
                                    "box_size": [12.0, 8.0, 12.0],
                                    "swirl_centre": [8.0, 6.0, 8.0]})
        cell.config["style_config"]["particle.keyframe_stride"] = 4
    mix = cell.traffic
    for key, small in (("frames_per_job", 13), ("frames", 3),
                       ("warm_check_max", 2), ("kf_check_max", 2)):
        if key in mix:
            mix[key] = small
    return cell


def window_seconds(cell) -> float:
    """A window that holds a streamed cell's cold frame and a warm one
    (the check then compares both); a batch or a job closes the others."""
    return 20.0 if cell.traffic["kind"] == "stream_grid" else 1e-3


def line(cell, faults=None, seed: int = 2 ** 31 + 3, device: str = "cpu"):
    """(result line, frames in the window) of one run of ``cell`` with
    ``faults`` applied to its timed path."""
    args = SimpleNamespace(
        seed=seed, trace=0,
        seconds=0.5 if device == "cpu" else window_seconds(cell))
    out = harness.kind_module(cell).run(cell, args, time.perf_counter(),
                                        device=device, faults=faults)
    return harness.result(cell, out, False, device, 1, "test"), out.frames


def unchanged_state(obj):
    """Adam's step returns the state it was given: no update."""
    styler = getattr(obj, "styler", obj)

    def update(grad, state):
        zero = {k: torch.zeros_like(g) for k, g in grad.items()} \
            if isinstance(grad, dict) else torch.zeros_like(grad)
        return zero, state
    styler._optimizer.update = update


def half_the_batch(obj):
    """Half of the image loss's batch left out, the mean taken over the
    rest: half the views of each window position or keyframe, or, where a
    batch holds several frames or keyframes (the joint engines), its
    later half."""
    styler = getattr(obj, "styler", obj)
    cls = type(styler)

    def weighted(imgs, pw, data):
        if imgs.shape[1] > 1:
            return cls._image_loss_weighted(
                styler, imgs[:, : imgs.shape[1] // 2], pw, data)
        n = imgs.shape[0] // 2
        return cls._image_loss_weighted(styler, imgs[:n], 2 * pw[:n], data)

    def per_set(imgs, data):
        B = imgs.shape[0]
        if B == 1:
            return cls._image_losses(styler, imgs[:, : imgs.shape[1] // 2],
                                     data)
        kept = cls._image_losses(styler, imgs[: B // 2], data)
        return torch.cat([kept, torch.zeros(B - B // 2, device=kept.device)])

    if hasattr(cls, "stylize_sequence"):   # the grid styler
        styler._image_loss_weighted = weighted
    else:
        styler._image_losses = per_set


def altered_answer(obj):
    """A quarter of each output left unstylized where it is produced: a
    grid frame's first z-slabs, or a keyframe param's first quarter of
    particles."""
    def alter(d_star, d):
        d_star = d_star.clone()
        q = d_star.shape[-3] // 4
        d_star[..., :q, :, :] = torch.as_tensor(
            d, dtype=torch.float32, device=d_star.device)[..., :q, :, :]
        return d_star

    styler = getattr(obj, "styler", obj)
    if hasattr(type(styler), "stylize_sequence"):
        if obj is not styler:           # the joint engine
            stylize = type(obj).stylize

            def joint(d, *a, **k):
                d_star, params, info = stylize(obj, d, *a, **k)
                return alter(d_star, d), params, info
            obj.stylize = joint
        else:
            frame = type(obj).stylize_frame

            def one(d, *a, **k):
                d_star, param, info = frame(obj, d, *a, **k)
                return alter(d_star, d), param, info
            obj.stylize_frame = one
    else:
        optimize = type(styler)._optimize_keyframes

        def keyframes(*a, **k):
            param, losses, overs = optimize(styler, *a, **k)
            n = next(iter(param.values())).shape[1] // 4
            return ({key: torch.cat([torch.zeros_like(v[:, :n]), v[:, n:]],
                                    dim=1) for key, v in param.items()},
                    losses, overs)
        styler._optimize_keyframes = keyframes


CELLS = ["tnst3d.stream", "lnst3d.keyframes", "tnst3d.joint16",
         "lnst3d.engine21"]


FAULTS = [unchanged_state, half_the_batch, altered_answer]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    got, frames = line(tiny(cell))
    assert frames >= 1 and got["checks"]
    assert got["correct"] is True, got["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_run_is_not_correct(cell, fault):
    got, _ = line(tiny(cell), fault)
    assert got["checks"] and got["correct"] is False, got["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_run_at_the_cells_size_is_not_correct(card, cell, fault):
    from test_benchmark_control import readings

    t = time.perf_counter()
    got, frames = line(harness.load_cell(cell), fault, device="cuda")
    print(readings(got, cell=cell, fault=fault.__name__, frames=frames,
                   s=time.perf_counter() - t), flush=True)
    assert got["correct"] is False, got["checks"]


if __name__ == "__main__":
    from test_benchmark_control import readings

    cells = [a for a in sys.argv[1:] if "." in a]
    for name in cells:
        for s in (int(a) for a in sys.argv[1:] if a.isdigit()):
            for f in FAULTS:
                t = time.perf_counter()
                got, frames = line(harness.load_cell(name), f, s, "cuda")
                print(readings(got, cell=name, seed=s, fault=f.__name__,
                               frames=frames, s=time.perf_counter() - t),
                      flush=True)
