"""Sequential LNST jobs with colour transfer:
``ParticleStyler.stylize_keyframes`` with ``particle.optimize_color``, as
``stream_keyframes`` runs them, every particle carrying a colour along
its identity. The finest octave splats density and colour in one
5-channel pass (``splat_binned_color``, span ``nfs.splat_color``) and
renders the colour volume; the coarse octaves optimize the density alone
in grid space.

Colours (:func:`particle_colors`): two fluids, split at the box's centre
in x at frame 0, each half its own base colour (``data.colors``), plus
uniform noise of up to ``data.color_noise`` drawn from (seed, job),
clipped to [0, 1]: some channels sit exactly at 0 and at 1, the clip's
ties.

Set-up, window and trace as ``stream_keyframes``; an output frame counts
when its positions, densities and colours are on the host. The traced
host pass (the first two keyframes) runs under the kind's own profiler,
whose raw events ``benchmark/spans.py`` reduces to device time by span:
``summary['spans']``, which the ``color_splat_*`` readers take.

What is checked, as ``stream_keyframes`` checks it, against the plain
reference ``reference/lnst_color.py``: keyframe 0 from the input colours,
keyframe k from the program's keyframe k - 1 (its colour as the program
gave it) and a frame between them. Beside the particle and loss gaps,
each colour gap, sum |got - want| / sum |want - c0| with c0 the input
colours: the mean colour error over the stylization's own mean change of
them. Keyframe 0's colour gap has a limit of its own
(``limits['kf0_color_gap']``), the warm keyframe's and the frame's
another (``limits['color_gap']``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, inputs, spans
from benchmark.harness import Check, Outcome
from benchmark.kinds.stream_grid import loss_gap
from benchmark.kinds.stream_keyframes import (
    keyframe_indices, lnst_least_s, particle_gap)
from benchmark.roofline import color as color_counts


def particle_colors(x0: torch.Tensor, seed: int, job: int, data: Dict,
                    device="cuda") -> torch.Tensor:
    """(N, 3) colours of particles at frame-0 positions x0: the base
    colour of the particle's half of the box in x, plus uniform noise in
    +-``color_noise`` from (seed, job), clipped to [0, 1]."""
    centre = data["box_lo"][2] + 0.5 * data["box_size"][2]
    side = (x0[:, 2] >= centre).long()
    base = torch.tensor(data["colors"], dtype=torch.float32,
                        device=device)[side]
    u = torch.rand(x0.shape, generator=inputs.generator(
        seed, 9, job, device=device), device=device)
    return (base + data["color_noise"] * (2.0 * u - 1.0)).clamp(0.0, 1.0)


def color_gap(got, want, base) -> float:
    """sum |got - want| / sum |want - base| of (N, 3) colours. A sum of
    absolute values and not a norm: a handful of the 3N channels, whose
    Adam step turns on a gradient near zero, differ by 1e-3 to 1e-2 in any
    two float32 runs, and a norm would read those alone."""
    return float((got.to(want.device) - want).abs().sum()
                 / (want - base).abs().sum())


def least_frame_s(sc: Dict, grid, frames: int, n_kf: int) -> float:
    """Least seconds a frame of the job: each keyframe's grey-render
    iterations (``lnst_least_s``) plus, at the finest octave, what the
    colour render adds."""
    size = sc["render.render_size"]
    extra = sc["optim.iters"] * color_counts.color_render_extra_least_s(
        grid, size, sc["render.n_views"])
    return n_kf * (lnst_least_s(sc, grid) + extra) / frames


def run(cell, args, t0: float, device: str = "cuda", faults=None) -> Outcome:
    """One run of the cell. ``faults``: test hooks that break the timed
    path or put the control in its place (``benchmark/tests``); None in
    every benchmark run."""
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.styler.particle import ParticleStyler

    conf, mix = cell.config, cell.traffic
    sc = dict(conf["style_config"])
    grid, n = tuple(conf["grid"]), conf["particles"]
    seed, F = args.seed, mix["frames_per_job"]
    stride = sc["particle.keyframe_stride"]
    kfs = keyframe_indices(F, stride)
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
        c0 = particle_colors(xs[0], seed, j, d, device=device)
        sched = inputs.view_schedule(seed, j, len(kfs), octaves, iters, 1,
                                     sc["render.view_pool"])[..., 0]
        return (xs, c0, [ParticleSet(x=x, dens=ones, color=c0) for x in xs],
                sched)

    cfg = replace(StyleConfig(), seed=seed, **sc)
    styler = ParticleStyler(cfg, grid_shape=grid, vgg_params=vgg,
                            style_image=style, device=device)
    if faults:
        faults(styler)
    xs, c0, psets, sched = job(0)
    # warm-up: one iteration per octave of the first two keyframes and the
    # frames between them
    warm = ParticleStyler(replace(cfg, **{"optim.iters": 1}), grid_shape=grid,
                          vgg_params=vgg, style_image=style, device=device)
    for _, ps in warm.stylize_keyframes(psets[:stride + 1],
                                        view_schedule=sched[:2, :, :1]):
        ps.color.cpu()
    del warm

    rng = np.random.default_rng([seed % 2 ** 63, 7])
    k = int(rng.integers(1, mix["kf_check_max"] + 1))
    t_mid = int(rng.integers(kfs[k - 1] + 1, kfs[k]))
    keep = set(kfs) | {t_mid}
    harness.open_window(device)
    setup_s = time.perf_counter() - t0

    out: Dict[int, tuple] = {}
    losses = overflow = None
    frames = failed = 0
    j, w0 = 0, time.perf_counter()
    while True:
        jp, js = (psets, sched) if j == 0 else job(j)[2:]
        for t, ps in styler.stylize_keyframes(jp, view_schedule=js):
            host = (ps.x.cpu(), ps.dens.cpu(), ps.color.cpu())
            frames += 1
            failed += int(not all(bool(torch.isfinite(h).all())
                                  for h in host))
            if j == 0 and t in keep:
                out[t] = host
        if j == 0:
            infos = styler.last_keyframe_infos
            losses = {kf: torch.stack(infos[kf]["octave_losses"]).cpu()
                      for kf in (kfs[0], kfs[k])}
            overflow = [max(infos[kf]["octave_overflow"]) for kf in kfs]
        j += 1
        if time.perf_counter() - w0 >= args.seconds:
            break
    window_s = time.perf_counter() - w0
    peak = harness.window_peak(device)
    summary = None
    if args.trace:
        summary = _traced(styler, job(j), stride, octaves * iters, len(kfs),
                          device)
        summary["s_per_frame"] = window_s / frames
        summary["least_frame_s"] = least_frame_s(sc, grid, F, len(kfs))
        summary["color_splat_least_s"] = 2 * iters * \
            color_counts.color_pass_least_s(int(np.prod(grid)), n)
    del styler
    harness.release(device)

    checks = check(sc, conf, seed, vgg, style, xs, c0, sched, kfs, k, t_mid,
                   out, losses, overflow, mix["limits"], device)
    return Outcome(frames=frames, window_s=window_s, setup_s=setup_s,
                   peak_bytes=peak, failed=failed, checks=checks,
                   summary=summary)


def _traced(styler, data, stride, iters_per_kf, n_kf, device) -> Dict:
    """One job with the card's activity alone (device time, busy share,
    launch calls), then its first two keyframes with the host's
    operators too, under a profiler of the kind's own: the idle gaps'
    names, and the device time by span (``summary['spans']``)."""
    from torch.profiler import ProfilerActivity, profile

    _, _, psets, sched = data

    def job(ps, sc):
        def step():
            for _, p in styler.stylize_keyframes(ps, view_schedule=sc):
                p.color.cpu()
        return step

    acts = [ProfilerActivity.CUDA]
    harness.warm_profiler(device)
    dev_events, wall = harness.trace(job(psets, sched), acts, device)
    prof = profile(activities=acts + [ProfilerActivity.CPU])
    harness.sync(device)
    prof.start()
    job(psets[:stride + 1], sched[:2])()
    harness.sync(device)
    prof.stop()
    summary = harness.reduce_events(dev_events, wall, n_kf * iters_per_kf,
                                    len(psets), harness._events(prof))
    summary["spans"] = spans.reduce(spans.raw_events(prof))
    return summary


def check(sc, conf, seed, vgg, style, xs, c0, sched, kfs, k, t_mid, out,
          losses, overflow, limits, device) -> List[Check]:
    """The reference's keyframes 0 and k, and frame t_mid, beside the
    program's."""
    from benchmark.reference.lnst_color import LnstColor

    ref = LnstColor(sc, conf["grid"], vgg, style, seed, device=device)
    n = xs.shape[1]
    ones = torch.ones(n, device=device)
    thresh = 4 * int(sc["particle.k_budget"] * n)

    def got(t):
        return tuple(a.to(device) for a in out[t])

    def recovered(i):
        x, dens, color = got(kfs[i])
        return dict(ref.recover(xs[kfs[i]], ones, x, dens), color=color)

    # the bin plan as the program keeps it: probed at the first keyframe,
    # probed again after a keyframe that parked more than 4x the budget
    plan0 = plan = ref.plan(xs[kfs[0]])
    for i in range(1, k + 1):
        if overflow[i - 1] > thresh:
            plan = ref.plan(ref.apply(xs[kfs[i]], ones,
                                      recovered(i - 1))[0])

    def gaps(name, t, want):
        x, dens, color = got(t)
        return [Check(f"{name}_gap", particle_gap((x, dens), want[:2],
                                                  (xs[t], ones)),
                      limits["kf_gap"]),
                Check(f"{name}_color_gap", color_gap(color, want[2], c0),
                      limits["kf0_color_gap" if name == "kf0"
                             else "color_gap"])]

    checks = []
    for name, i in (("kf0", 0), ("kf", k)):
        init = (ref.cold(xs[0], ones, c0) if i == 0 else recovered(i - 1))
        p_ref, l_ref = ref.keyframe(xs[kfs[i]], ones, sched[i],
                                    plan0 if i == 0 else plan, init)
        checks += gaps(name, kfs[i], ref.apply(xs[kfs[i]], ones, p_ref))
        checks.append(Check(f"{name}_loss_gap",
                            loss_gap(losses[kfs[i]], l_ref),
                            limits["kf_loss_gap"]))
    alpha = (t_mid - kfs[k - 1]) / (kfs[k] - kfs[k - 1])
    checks += gaps("interp", t_mid, ref.apply(
        xs[t_mid], ones, ref.lerp(recovered(k - 1), p_ref, alpha)))
    return checks
