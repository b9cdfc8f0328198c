"""Streamed TNST jobs: ``GridStyler.stylize_sequence`` with ``fused=0``,
each frame warm-started from the one before (the MacCormack transport of
its param) and optimized under the Gaussian-window transport loss.

The mix (``traffic/<name>.json``): ``frames_per_job`` frames a job, jobs
back to back, each job's densities and view draws drawn from (seed, job).
Set-up makes the inputs, builds the styler and warms every shape up with
one iteration per octave on a cold and a warm frame. The window opens at
the start of a frame and closes at the end of the first frame that ends
after ``--seconds``; a frame counts when its density is on the host. With
``--trace 1``, ``traced_frames`` more frames run under torch.profiler
after the window.

What is checked: the first frame (cold, from zeros) and one warm frame
``k`` drawn from the seed in 1..``warm_check_max`` (the last frame of the
window where it holds fewer), each stylized again by the plain reference
from the same inputs: the gap of the output density (against the
stylization's own change of the frame), and the widest relative gap of
the per-iteration losses. The warm frame starts from the program's own param
of frame k - 1 (its output, handed to the reference), transported by the
reference's own MacCormack step.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.harness import Check, Outcome
from benchmark.roofline import counts


def window_vels(vels: torch.Tensor, t: int, W: int) -> torch.Tensor:
    """(2W, ...) velocities of frames t-W..t+W-1, clamped to the job."""
    T = vels.shape[0]
    return torch.stack([vels[min(max(i, 0), T - 1)]
                        for i in range(t - W, t + W)])


def rel_gap(got: torch.Tensor, want: torch.Tensor,
            base: torch.Tensor) -> float:
    """||got - want|| / ||want - base||: the gap against the stylization's
    own change of the frame."""
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want - base))


def loss_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest relative gap of per-iteration losses."""
    got = got.to(want.device, torch.float32)
    return float(((got - want).abs() / want.abs()).max())


def frame_least_s(sc: Dict, shape) -> float:
    """Least seconds of one frame's iterations (every octave)."""
    from benchmark.reference.tnst import octave_shapes, render_size

    full = tuple(shape)
    total = 0.0
    for o in octave_shapes(full, sc["optim.octave_n"],
                           sc["optim.octave_scale"]):
        size = render_size(o, full, sc["render.render_size"],
                           sc.get("render.min_render_size", 64))
        total += sc["optim.iters"] * counts.tnst_iteration_least_s(
            o, size, sc["render.n_views"], 2 * sc["optim.window"] + 1,
            sc["loss.style_layers"])
    return total


def frame_transport_least_s(sc: Dict, shape, warm: bool) -> float:
    """Least seconds of the advections one frame needs: per iteration, W
    forward and W backward taps (K1) and their field gradients (K2); a
    warm frame also the two K1 of its MacCormack warm start."""
    from benchmark.reference.tnst import octave_shapes

    W = sc["optim.window"]
    total = 0.0
    for o in octave_shapes(shape, sc["optim.octave_n"],
                           sc["optim.octave_scale"]):
        n = int(np.prod(o))
        total += sc["optim.iters"] * 2 * W * (
            counts.advect_least_s("fwd", n) + counts.advect_least_s(
                "bwd_field", n))
    if warm:
        total += 2 * counts.advect_least_s("fwd", int(np.prod(shape)))
    return total


def run(cell, args, t0: float, device: str = "cuda", faults=None) -> Outcome:
    """One run of the cell. ``faults``: test hooks that break the timed
    path or put the control in its place (``benchmark/tests``); None in
    every benchmark run."""
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.styler.grid import GridStyler

    conf, mix = cell.config, cell.traffic
    sc = dict(conf["style_config"])
    shape = tuple(conf["grid"])
    seed, F = args.seed, mix["frames_per_job"]
    W = sc["optim.window"]
    octaves, iters = sc["optim.octave_n"], sc["optim.iters"]
    harness.load_kernels(device)

    vgg = inputs.vgg_weights(seed, sc["loss.style_layers"], device=device)
    style = inputs.style_image(conf["data"]["style"])
    vels = inputs.swirl_velocity(shape, F, conf["data"]["swirl_cap"],
                                 device=device)

    def job(j):
        return (inputs.plume_density(shape, F, seed, j, device=device),
                inputs.view_schedule(seed, j, F, octaves, iters, 2 * W + 1,
                                     sc["render.view_pool"]))

    cfg = replace(StyleConfig(), seed=seed, **sc)
    styler = GridStyler(cfg, vgg_params=vgg, style_image=style,
                        device=device)
    if faults:
        faults(styler)
    dens, sched = job(0)
    # warm-up: one iteration per octave of a cold and a warm frame
    warm = GridStyler(replace(cfg, **{"optim.iters": 1}), vgg_params=vgg,
                      style_image=style, device=device)
    for _, d_star, _ in warm.stylize_sequence(
            dens[:2], vels[:2], fused=0, view_schedule=sched[:2, :, :1]):
        d_star.cpu()
    del warm

    rng = np.random.default_rng([seed % 2 ** 63, 4])
    k = int(rng.integers(1, mix["warm_check_max"] + 1))
    harness.open_window(device)
    setup_s = time.perf_counter() - t0

    def stream():
        j, d, s = 0, dens, sched
        while True:
            for t, d_star, param in styler.stylize_sequence(
                    d, vels, fused=0, view_schedule=s):
                yield j, t, d_star, param
            j += 1
            d, s = job(j)

    kept: Dict[int, torch.Tensor] = {}
    kept_losses: Dict[int, torch.Tensor] = {}
    last_params: List = []
    prev_k = None
    frames = failed = 0
    gen = stream()
    w0 = time.perf_counter()
    for j, t, d_star, param in gen:
        host = d_star.cpu()
        frames += 1
        failed += int(not bool(torch.isfinite(host).all()))
        if j == 0:
            kept[t] = host
            kept_losses[t] = styler.frame_losses[t]
            if t == k - 1:
                prev_k = param.cpu()
            last_params = (last_params + [param])[-2:]
        if time.perf_counter() - w0 >= args.seconds:
            break
    window_s = time.perf_counter() - w0
    peak = harness.window_peak(device)
    if prev_k is None or k not in kept:       # the window ended before k
        k = max(t for t in kept)
        prev_k = last_params[0].cpu() if k > 0 else None
    summary = None
    if args.trace:
        summary = _traced(gen, mix["traced_frames"], octaves * iters, device)
        summary["s_per_frame"] = window_s / frames
        summary["least_frame_s"] = frame_least_s(sc, shape)
        summary["transport_least_s"] = (
            summary["frames"] * frame_transport_least_s(sc, shape, True))
    gen.close()
    del styler, gen, last_params
    harness.release(device)

    checks = check(sc, seed, vgg, style, dens, vels, sched, kept,
                   kept_losses, k, prev_k, mix["limits"], device)
    return Outcome(frames=frames, window_s=window_s, setup_s=setup_s,
                   peak_bytes=peak, failed=failed, checks=checks,
                   summary=summary)


def _traced(gen, n_frames: int, iters_per_frame: int, device) -> Dict:
    """``n_frames`` more frames of the stream traced twice over: first
    with the card's activity alone (device time, busy share, launch
    calls: the lightest tracing), then with the host's operators too (the
    idle gaps named by what the host was doing), reduced to the harness's
    summary."""
    from torch.profiler import ProfilerActivity

    def one(activities):
        def step():
            for _ in range(n_frames):
                _, _, d_star, _ = next(gen)
                d_star.cpu()
        return harness.trace(step, activities, device)

    acts = [ProfilerActivity.CUDA]
    harness.warm_profiler(device)
    dev_events, wall = one(acts)
    host_events, _ = one(acts + [ProfilerActivity.CPU])
    return harness.reduce_events(dev_events, wall, n_frames * iters_per_frame,
                                 n_frames, host_events)


def check(sc, seed, vgg, style, dens, vels, sched, kept, kept_losses, k,
          prev_k, limits, device) -> List[Check]:
    """The plain reference's frames 0 and k beside the program's."""
    from benchmark.reference.tnst import Tnst

    W = sc["optim.window"]
    ref = Tnst(sc, vgg, style, seed, device=device)
    out = []
    for name, t in (("cold", 0), ("warm", k)):
        if t not in kept or (name == "warm" and (t == 0 or prev_k is None)):
            continue
        init = (None if t == 0 else
                ref.warm_start(prev_k.to(device), vels[t - 1]))
        d_ref, _, losses = ref.frame(dens[t], window_vels(vels, t, W),
                                     sched[t], init)
        out.append(Check(f"{name}_gap", rel_gap(kept[t].to(device), d_ref,
                                                dens[t]),
                         limits[f"{name}_gap"]))
        out.append(Check(f"{name}_loss_gap", loss_gap(kept_losses[t], losses),
                         limits[f"{name}_loss_gap"]))
    return out
