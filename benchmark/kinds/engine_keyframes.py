"""Keyframe-parallel LNST jobs: ``ParallelKeyframeStyler.stylize_keyframes``
on a (1, 1) mesh, every keyframe of a job optimized together from zeros
(one binning, splat and render per iteration for all of them, VGG over
all their views), then the frames between interpolated.

The mix (``traffic/<name>.json``): ``frames_per_job`` frames a job, jobs
back to back, each job's particles and view draws drawn from (seed,
job). Set-up makes the inputs, builds the styler and the engine and warms
the job's shapes up with one iteration per octave. The window opens at
the start of a job and closes at the end of the first job that ends after
``--seconds``; an output frame counts when its particles are on the host.
With ``--trace 1`` one more job runs traced with the card's activity
alone, then once more with the host's operators too.

What is checked, on the first job: the batch's first and last keyframes,
two neighbouring keyframes between them drawn from the seed, and a frame
between those two, each worked out again by the plain reference from the
same inputs (each keyframe from zeros, with the bin plan of its own
occupancy probe, as the engine plans it); the gaps of the output
particles and the widest relative gap of each keyframe's per-iteration
losses. The batch's two ends are always checked, so a fault that drops
or garbles a part of the batch at either end shows.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.harness import Check, Outcome
from benchmark.kinds.stream_grid import loss_gap
from benchmark.kinds.stream_keyframes import (
    keyframe_indices, lnst_least_s, particle_gap, splat_least_s)


def run(cell, args, t0: float, device: str = "cuda", faults=None) -> Outcome:
    """One run of the cell. ``faults``: test hooks that break the timed
    path or put the control in its place (``benchmark/tests``); None in
    every benchmark run."""
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.parallel.mesh import make_mesh
    from nfs_tpu_torch.parallel.particles import ParallelKeyframeStyler
    from nfs_tpu_torch.styler.particle import ParticleStyler

    conf, mix = cell.config, cell.traffic
    sc = dict(conf["style_config"])
    grid, n = tuple(conf["grid"]), conf["particles"]
    seed, F = args.seed, mix["frames_per_job"]
    kfs = keyframe_indices(F, sc["particle.keyframe_stride"])
    octaves, iters = sc["optim.octave_n"], sc["optim.iters"]
    harness.load_kernels(device)

    vgg = inputs.vgg_weights(seed, sc["loss.style_layers"], device=device)
    style = inputs.style_image(conf["data"]["style"])
    ones = torch.ones(n, device=device)

    def job(j):
        d = conf["data"]
        xs = inputs.particle_frames(n, F, seed, j, d["box_lo"],
                                    d["box_size"], d["swirl_centre"],
                                    device=device)
        sched = inputs.view_schedule(seed, j, len(kfs), octaves, iters, 1,
                                     sc["render.view_pool"])[..., 0]
        return xs, [ParticleSet(x=x, dens=ones) for x in xs], sched

    def engine(c):
        return ParallelKeyframeStyler(
            ParticleStyler(c, grid_shape=grid, vgg_params=vgg,
                           style_image=style, device=device), make_mesh(1, 1))

    cfg = replace(StyleConfig(), seed=seed, **sc)
    eng = engine(cfg)
    if faults:
        faults(eng)
    xs, psets, sched = job(0)
    warm = engine(replace(cfg, **{"optim.iters": 1}))
    for _, ps in warm.stylize_keyframes(psets, view_schedule=sched[:, :, :1]):
        ps.x.cpu()
    del warm

    rng = np.random.default_rng([seed % 2 ** 63, 8])
    i = int(rng.integers(1, len(kfs) - 2))     # the pair lies inside
    t_mid = int(rng.integers(kfs[i] + 1, kfs[i + 1]))
    checked = {"first": 0, "kf0": i, "kf1": i + 1, "last": len(kfs) - 1}
    keep = {kfs[b] for b in checked.values()} | {t_mid}
    harness.open_window(device)
    setup_s = time.perf_counter() - t0

    out: Dict[int, tuple] = {}
    losses = None
    frames = failed = 0
    j, w0 = 0, time.perf_counter()
    while True:
        _, jp, js = (xs, psets, sched) if j == 0 else job(j)
        for t, ps in eng.stylize_keyframes(jp, view_schedule=js):
            host = (ps.x.cpu(), ps.dens.cpu())
            frames += 1
            failed += int(not all(bool(torch.isfinite(h).all())
                                  for h in host))
            if j == 0 and t in keep:
                out[t] = host
        if j == 0:
            losses = {kfs[b]: torch.stack(
                eng.last_keyframe_infos[kfs[b]]["octave_losses"]).cpu()
                for b in checked.values()}
        j += 1
        if time.perf_counter() - w0 >= args.seconds:
            break
    window_s = time.perf_counter() - w0
    peak = harness.window_peak(device)
    summary = None
    if args.trace:
        summary = _traced(eng, job(j), octaves * iters, device)
        summary["s_per_frame"] = window_s / frames
        summary["least_frame_s"] = len(kfs) * lnst_least_s(sc, grid) / F
        summary["splat_least_s"] = len(kfs) * splat_least_s(sc, grid, n)
    del eng
    harness.release(device)

    checks = check(sc, conf, seed, vgg, style, xs, sched, kfs, checked,
                   t_mid, out, losses, mix["limits"], device)
    return Outcome(frames=frames, window_s=window_s, setup_s=setup_s,
                   peak_bytes=peak, failed=failed, checks=checks,
                   summary=summary)


def _traced(eng, data, iters, device) -> Dict:
    """One job with the card's activity alone, then once more with the
    host's operators too."""
    from torch.profiler import ProfilerActivity

    _, psets, sched = data

    def step():
        for _, p in eng.stylize_keyframes(psets, view_schedule=sched):
            p.x.cpu()

    acts = [ProfilerActivity.CUDA]
    harness.warm_profiler(device)
    dev_events, wall = harness.trace(step, acts, device)
    host_events, _ = harness.trace(step, acts + [ProfilerActivity.CPU],
                                   device)
    return harness.reduce_events(dev_events, wall, iters, len(psets),
                                 host_events)


def check(sc, conf, seed, vgg, style, xs, sched, kfs, checked, t_mid, out,
          losses, limits, device) -> List[Check]:
    """The reference's keyframes ``checked`` ({name: index into kfs}) and
    frame t_mid, between keyframes ``kf0`` and ``kf1``, beside the
    program's."""
    from benchmark.reference.lnst import Lnst

    ref = Lnst(sc, conf["grid"], vgg, style, seed, device=device)
    ones = torch.ones(xs.shape[1], device=device)
    params, checks = {}, []
    for name, b in checked.items():
        x = xs[kfs[b]]
        p_ref, l_ref = ref.keyframe(x, ones, sched[b], ref.plan(x))
        params[name] = p_ref
        got = tuple(a.to(device) for a in out[kfs[b]])
        checks.append(Check(f"{name}_gap", particle_gap(
            got, ref.apply(x, ones, p_ref), (x, ones)), limits["kf_gap"]))
        checks.append(Check(f"{name}_loss_gap",
                            loss_gap(losses[kfs[b]], l_ref),
                            limits["kf_loss_gap"]))
    i = checked["kf0"]
    alpha = (t_mid - kfs[i]) / (kfs[i + 1] - kfs[i])
    want = ref.apply(xs[t_mid], ones,
                     ref.lerp(params["kf0"], params["kf1"], alpha))
    got = tuple(a.to(device) for a in out[t_mid])
    checks.append(Check("interp_gap", particle_gap(
        got, want, (xs[t_mid], ones)), limits["kf_gap"]))
    return checks
