"""The control of every cell's comparison: the plain reference put in the
program's place, one precision below what the configuration states, has
to come out as not correct through the harness's own path (the cell's
kind runs its window and its check, ``harness.result`` decides).

The configuration states bfloat16 features and float32 shears and Gram
products with TF32 off, so there are two controls: ``fp8`` rounds every
convolution's input and weights to float8 e4m3, ``tf32`` lets the float32
shears and Gram run in TF32. The control takes the timed path's place
where the program stylizes: a grid frame (``GridStyler.stylize_frame``,
warm-started by the program's own transport of the control's previous
param), a joint batch (``ParallelSequenceStyler.stylize``), a keyframe
batch (``ParticleStyler._optimize_keyframes``, under both LNST entries).

At the cells' own size on the card (marker ``cuda``):

    python -m pytest benchmark/tests/test_benchmark_control.py -m cuda

or, to print the readings of some seeds:

    python3 benchmark/tests/test_benchmark_control.py <cell>... <seed>... \\
        [fp8] [tf32]

At a size the CPU holds, the ``fp8`` control (TF32 exists only on the
card) comes out not correct too, and the reference in the program's place
at the stated precision comes out correct.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CELLS = ["tnst3d.stream", "lnst3d.keyframes", "tnst3d.joint16",
         "lnst3d.engine21"]


def control_hook(cell, seed: int, precision: str, device: str):
    """A ``faults`` hook for the cell's kind that puts the reference, at
    ``precision``, in the program's place. It takes the inputs the kind
    makes from the seed, made again here alike."""
    import torch

    from benchmark import inputs
    from benchmark.kinds.stream_grid import window_vels
    from benchmark.reference.lnst import Lnst
    from benchmark.reference.tnst import Tnst

    conf = cell.config
    sc = conf["style_config"]
    vgg = inputs.vgg_weights(seed, sc["loss.style_layers"], device=device)
    style = inputs.style_image(conf["data"]["style"])

    if "particles" in conf:
        ctl = Lnst(sc, conf["grid"], vgg, style, seed, device=device,
                   precision=precision)

        def keyframes(param, x, dens, plan, generators, schedules=None,
                      callback=None):
            outs, losses = [], []
            for b in range(x.shape[0]):
                p, ls = ctl.keyframe(x[b], dens[b], np.asarray(schedules[b]),
                                     plan[b], {k: v[b] for k, v in
                                               param.items()})
                outs.append(p)
                losses.append(ls)
            ls = torch.stack(losses)                   # (B, octaves, iters)
            return ({k: torch.stack([p[k] for p in outs]) for k in outs[0]},
                    list(ls.unbind(1)),
                    torch.zeros(ls.shape[:2], dtype=torch.long,
                                device=x.device))

        def hook(obj):
            getattr(obj, "styler", obj)._optimize_keyframes = keyframes
        return hook

    ctl = Tnst(sc, vgg, style, seed, device=device, precision=precision)
    W = sc["optim.window"]

    def frame(d, vels=None, init_param=None, generator=None, callback=None,
              checkpoint_path=None, warm=None, view_schedule=None,
              space=None):
        d_star, param, ls = ctl.frame(d, vels, np.asarray(view_schedule),
                                      init_param)
        return d_star, param, {"octave_losses": list(ls.unbind(0))}

    def batch(d, vels, view_schedule=None, **_):
        outs, params, losses = [], [], []
        for i in range(d.shape[0]):
            sched = np.repeat(np.asarray(view_schedule[i])[..., None],
                              2 * W + 1, axis=-1)
            o, p, ls = ctl.frame(d[i], window_vels(vels, i, W), sched)
            outs.append(o)
            params.append(p)
            losses.append(ls)
        mean = torch.stack(losses).mean(0)             # (octaves, iters)
        return (torch.stack(outs), torch.stack(params),
                {"octave_losses": list(mean.unbind(0))})

    def hook(obj):
        if hasattr(obj, "styler"):                     # the joint engine
            obj.stylize = batch
        else:
            obj.stylize_frame = frame
    return hook


def readings(line, **about) -> str:
    """One JSON line: what was run, ``correct`` and each number compared."""
    return json.dumps({**about, "correct": line["correct"],
                       **{k: v["value"] for k, v in line["checks"].items()}})


def control_line(cell, seed: int, precision: str, device: str = "cuda"):
    """(result line, frames in the window) of one run of ``cell`` with the
    control in the program's place."""
    from test_benchmark_faults import line

    return line(cell, control_hook(cell, seed, precision, device), seed,
                device)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", ["fp8", "tf32"])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 7, 424242])
def test_control_is_not_correct(card, cell, precision, seed):
    from benchmark import harness

    t = time.perf_counter()
    got, frames = control_line(harness.load_cell(cell), seed, precision)
    print(readings(got, cell=cell, seed=seed, precision=precision,
                   frames=frames, s=time.perf_counter() - t), flush=True)
    assert got["correct"] is False, got["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", ["program", "fp8"])
def test_the_control_at_a_small_size(cell, precision):
    """The reference in the program's place at the stated precision comes
    out correct, so the control's failure is its precision's."""
    from test_benchmark_faults import tiny

    got, _ = control_line(tiny(cell), 2 ** 31 + 3, precision, device="cpu")
    assert got["correct"] is (precision == "program"), got["checks"]


if __name__ == "__main__":
    from benchmark import harness

    cells = [a for a in sys.argv[1:] if "." in a]
    precs = [a for a in sys.argv[1:] if a in ("fp8", "tf32")] or ["fp8"]
    for name in cells:
        c = harness.load_cell(name)
        for s in (int(a) for a in sys.argv[1:] if a.isdigit()):
            for p in precs:
                t = time.perf_counter()
                got, frames = control_line(c, s, p)
                print(readings(got, cell=name, seed=s, precision=p,
                               frames=frames, s=time.perf_counter() - t),
                      flush=True)
