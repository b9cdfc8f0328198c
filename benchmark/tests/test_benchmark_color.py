"""The colour cell ``lnst3d.color`` through the harness's own path, as
``test_benchmark_faults.py`` and ``test_benchmark_control.py`` hold the
other cells: a sound run comes out correct, and a run whose colour is
broken underneath comes out not correct, once for each fault the colour
can have: left unchanged by Adam, two channels swapped where the
keyframe's param is produced, every second keyframe's colour change
dropped (keyframes 0, 2, 4, ... keep the colour they started from); and
once for each fault that ``test_benchmark_faults.py`` plants in every
cell (Adam's step leaving the state unchanged, half of the views left
out, a quarter of each keyframe's particles left unstylized). Its
controls, the plain reference one precision below in the program's place
(``fp8``, ``tf32``), come out not correct at the cell's own size on the
card (marker ``cuda``); at a small size on the CPU the reference at the
stated precision comes out correct and the ``fp8`` one does not.

To print the readings of some seeds on the card:

    python3 benchmark/tests/test_benchmark_color.py <seed>... \\
        [sound] [faults] [fp8] [tf32]
"""

import itertools
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from test_benchmark_control import readings  # noqa: E402
from test_benchmark_faults import FAULTS as GENERIC  # noqa: E402
from test_benchmark_faults import line, tiny  # noqa: E402

CELL = "lnst3d.color"


def color_unchanged(styler):
    """Adam leaves the colour where it started; position and density
    still move."""
    update = styler._optimizer.update

    def no_color(grad, state):
        updates, state = update(grad, state)
        if isinstance(updates, dict):       # not a coarse octave's field
            updates = dict(updates, color=torch.zeros_like(updates["color"]))
        return updates, state
    styler._optimizer.update = no_color


def channels_swapped(styler):
    """Each keyframe's red and green colour swapped where the keyframe's
    param is produced."""
    optimize = type(styler)._optimize_keyframes

    def keyframes(*a, **k):
        param, losses, overs = optimize(styler, *a, **k)
        return dict(param, color=param["color"][..., [1, 0, 2]]), losses, \
            overs
    styler._optimize_keyframes = keyframes


def half_the_colors(styler):
    """Every second keyframe, the first included, hands on the colour it
    started from: its colour change dropped."""
    optimize = type(styler)._optimize_keyframes
    calls = itertools.count()

    def keyframes(param, *a, **k):
        start = param["color"]
        out, losses, overs = optimize(styler, param, *a, **k)
        if next(calls) % 2 == 0:
            out = dict(out, color=start)
        return out, losses, overs
    styler._optimize_keyframes = keyframes


FAULTS = [color_unchanged, channels_swapped, half_the_colors] + GENERIC


def control_hook(cell, seed: int, precision: str, device: str):
    """A ``faults`` hook that puts the colour reference, at
    ``precision``, in the place of the program's keyframe batch
    (``ParticleStyler._optimize_keyframes``), on the inputs the kind
    makes from the seed, made again here alike."""
    from benchmark import inputs
    from benchmark.reference.lnst_color import LnstColor

    conf = cell.config
    sc = conf["style_config"]
    vgg = inputs.vgg_weights(seed, sc["loss.style_layers"], device=device)
    ctl = LnstColor(sc, conf["grid"], vgg,
                    inputs.style_image(conf["data"]["style"]), seed,
                    device=device, precision=precision)

    def keyframes(param, x, dens, plan, generators, schedules=None,
                  callback=None):
        outs, losses = [], []
        for b in range(x.shape[0]):
            p, ls = ctl.keyframe(x[b], dens[b], np.asarray(schedules[b]),
                                 plan[b], {k: v[b] for k, v in param.items()})
            outs.append(p)
            losses.append(ls)
        ls = torch.stack(losses)
        return ({k: torch.stack([p[k] for p in outs]) for k in outs[0]},
                list(ls.unbind(1)),
                torch.zeros(ls.shape[:2], dtype=torch.long, device=x.device))

    def hook(styler):
        styler._optimize_keyframes = keyframes
    return hook


def test_a_sound_run_is_correct():
    got, frames = line(tiny(CELL))
    assert frames >= 1 and got["checks"]
    assert {"kf0_color_gap", "kf_color_gap", "interp_color_gap"} <= set(
        got["checks"])
    assert got["correct"] is True, got["checks"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_colour_is_not_correct(fault):
    got, _ = line(tiny(CELL), fault)
    assert got["checks"] and got["correct"] is False, got["checks"]


@pytest.mark.parametrize("precision", ["program", "fp8"])
def test_the_control_at_a_small_size(precision):
    cell = tiny(CELL)
    seed = 2 ** 31 + 3
    got, _ = line(cell, control_hook(cell, seed, precision, "cpu"), seed)
    assert got["correct"] is (precision == "program"), got["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_colour_at_the_cells_size_is_not_correct(card, fault):
    got, _ = line(harness.load_cell(CELL), fault, device="cuda")
    assert got["correct"] is False, got["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp8", "tf32"])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7, 424242])
def test_control_is_not_correct(card, precision, seed):
    cell = harness.load_cell(CELL)
    got, _ = line(cell, control_hook(cell, seed, precision, "cuda"), seed,
                  "cuda")
    assert got["correct"] is False, got["checks"]


if __name__ == "__main__":
    cell = harness.load_cell(CELL)
    words = sys.argv[1:]
    what = [w for w in words if not w.isdigit()] or ["sound"]
    for s in (int(a) for a in words if a.isdigit()):
        runs = []
        if "sound" in what:
            runs.append(("sound", None))
        if "faults" in what:
            runs += [(f.__name__, f) for f in FAULTS]
        runs += [(p, control_hook(cell, s, p, "cuda"))
                 for p in ("fp8", "tf32") if p in what]
        for name, hook in runs:
            t = time.perf_counter()
            got, frames = line(cell, hook, s, "cuda")
            print(readings(got, cell=CELL, seed=s, run=name, frames=frames,
                           s=time.perf_counter() - t), flush=True)
