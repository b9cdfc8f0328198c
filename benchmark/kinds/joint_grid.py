"""Jointly stylized TNST batches: ``ParallelSequenceStyler.stylize`` on a
(1, 1) mesh, all ``frames`` frames of a batch optimized together (every
advection tap one batched launch for the batch, every frame's window
states and views through VGG in one batch), then the next ``frames`` of
the same job.

The mix (``traffic/<name>.json``): ``frames_per_job`` frames a job, cut
into batches of ``frames``; each job's densities and view draws drawn
from (seed, job). Set-up makes the inputs, builds the styler and the
engine and warms the batch's shapes up with one iteration per octave. The
window opens at the start of a batch and closes at the end of the first
batch that ends after ``--seconds``; a batch's frames count when its
densities are on the host. With ``--trace 1`` one more batch runs under
torch.profiler after the window.

What is checked, on the window's first batch: ``checked`` frames drawn
from the seed, each stylized again by the plain reference from the same
inputs (every frame of a batch starts from zeros; its window velocities
clamp to the batch, as the engine's halo does), the gap of the output
density; and the batch's first loss (the mean over its frames at the
coarsest octave's first iteration, where every param is 0) beside the
reference's.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.harness import Check, Outcome
from benchmark.kinds.stream_grid import (
    frame_least_s, frame_transport_least_s, rel_gap, window_vels)


def run(cell, args, t0: float, device: str = "cuda", faults=None) -> Outcome:
    """One run of the cell. ``faults``: test hooks that break the timed
    path or put the control in its place (``benchmark/tests``); None in
    every benchmark run."""
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.parallel.engine import ParallelSequenceStyler
    from nfs_tpu_torch.parallel.mesh import make_mesh
    from nfs_tpu_torch.styler.grid import GridStyler

    conf, mix = cell.config, cell.traffic
    sc = dict(conf["style_config"])
    shape = tuple(conf["grid"])
    seed, F, T = args.seed, mix["frames_per_job"], mix["frames"]
    octaves, iters = sc["optim.octave_n"], sc["optim.iters"]
    harness.load_kernels(device)

    vgg = inputs.vgg_weights(seed, sc["loss.style_layers"], device=device)
    style = inputs.style_image(conf["data"]["style"])
    vels = inputs.swirl_velocity(shape, F, conf["data"]["swirl_cap"],
                                 device=device)

    def job(j):
        return (inputs.plume_density(shape, F, seed, j, device=device),
                inputs.view_schedule(seed, j, F, octaves, iters, 1,
                                     sc["render.view_pool"])[..., 0])

    cfg = replace(StyleConfig(), seed=seed, **sc)
    engine = ParallelSequenceStyler(
        GridStyler(cfg, vgg_params=vgg, style_image=style, device=device),
        make_mesh(1, 1))
    if faults:
        faults(engine)
    dens, sched = job(0)
    # warm-up: the batch's shapes, one iteration per octave
    warm = ParallelSequenceStyler(
        GridStyler(replace(cfg, **{"optim.iters": 1}), vgg_params=vgg,
                   style_image=style, device=device), make_mesh(1, 1))
    warm.stylize(dens[:T], vels[:T], view_schedule=sched[:T, :, :1])[0].cpu()
    del warm

    def batches():
        j, d, s = 0, dens, sched
        while True:
            for b0 in range(0, F - T + 1, T):
                sl = slice(b0, b0 + T)
                yield j, b0, engine.stylize(d[sl], vels[sl],
                                            view_schedule=s[sl])
            j += 1
            d, s = job(j)

    harness.open_window(device)
    setup_s = time.perf_counter() - t0
    frames = failed = 0
    first = None
    gen = batches()
    w0 = time.perf_counter()
    for j, b0, (d_star, _, info) in gen:
        host = d_star.cpu()
        frames += host.shape[0]
        failed += int((~torch.isfinite(host)).flatten(1).any(1).sum())
        if first is None:
            first = (j, b0, host, float(info["octave_losses"][0][0]))
        if time.perf_counter() - w0 >= args.seconds:
            break
    window_s = time.perf_counter() - w0
    peak = harness.window_peak(device)
    summary = None
    if args.trace:
        summary = _traced(gen, octaves * iters, T, device)
        summary["s_per_frame"] = window_s / frames
        summary["least_frame_s"] = frame_least_s(sc, shape)
        summary["transport_least_s"] = T * frame_transport_least_s(
            sc, shape, False)
    gen.close()
    del engine, gen
    harness.release(device)

    checks = check(sc, seed, vgg, style, dens, vels, sched, first,
                   mix, device)
    return Outcome(frames=frames, window_s=window_s, setup_s=setup_s,
                   peak_bytes=peak, failed=failed, checks=checks,
                   summary=summary)


def _traced(gen, iters_per_frame: int, T: int, device) -> Dict:
    """One more batch traced with the card's activity alone, then one
    with the host's operators too (see ``stream_grid._traced``)."""
    from torch.profiler import ProfilerActivity

    def step():
        next(gen)[2][0].cpu()

    acts = [ProfilerActivity.CUDA]
    harness.warm_profiler(device)
    dev_events, wall = harness.trace(step, acts, device)
    host_events, _ = harness.trace(step, acts + [ProfilerActivity.CPU],
                                   device)
    return harness.reduce_events(dev_events, wall, iters_per_frame, T,
                                 host_events)


def check(sc, seed, vgg, style, dens, vels, sched, first, mix,
          device) -> List[Check]:
    from benchmark.reference.tnst import (
        Tnst, octave_shapes, render_size, resize)

    j, b0, host, first_loss = first
    T, W = mix["frames"], sc["optim.window"]
    if j != 0:
        raise RuntimeError("the window's first batch is the first job's")
    d = dens[b0:b0 + T]
    v = vels[b0:b0 + T]
    s = sched[b0:b0 + T]
    ref = Tnst(sc, vgg, style, seed, device=device)
    limits = mix["limits"]
    # the batch's first loss: every frame at param 0, coarsest octave
    full = tuple(d.shape[1:])
    o0 = octave_shapes(full, sc["optim.octave_n"], sc["optim.octave_scale"])[0]
    size = render_size(o0, full, sc["render.render_size"],
                       sc.get("render.min_render_size", 64))
    with torch.no_grad():
        losses = []
        for i in range(T):
            vw = torch.stack([resize(x, o0, is_velocity=True)
                              for x in window_vels(v, i, W)])
            views = ref.pool[torch.as_tensor(s[i, 0, 0])]
            losses.append(ref.loss(resize(d[i], o0), vw,
                                   views[None].expand(2 * W + 1, -1, -1),
                                   size))
        want = float(torch.stack(losses).mean())
    out = [Check("first_loss_gap", abs(first_loss - want) / abs(want),
                 limits["first_loss_gap"])]
    rng = np.random.default_rng([seed % 2 ** 63, 5])
    picks = sorted(rng.choice(T, size=mix["checked"], replace=False))
    for n, i in enumerate(picks):
        sched_i = np.repeat(s[i][..., None], 2 * W + 1, axis=-1)
        d_ref, _, _ = ref.frame(d[i], window_vels(v, i, W), sched_i)
        out.append(Check(f"frame{n}_gap",
                         rel_gap(host[i].to(device), d_ref, d[i]),
                         limits["frame_gap"]))
    return out
