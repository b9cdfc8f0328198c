"""Sequential LNST jobs: ``ParticleStyler.stylize_keyframes`` over a
particle sequence, every ``keyframe_stride``-th frame (and the last) a
keyframe optimized from the one before, the frames between interpolated
along particle identity.

The mix (``traffic/<name>.json``): ``frames_per_job`` frames a job, jobs
back to back, each job's particles and view draws drawn from (seed,
job). Set-up makes the inputs, builds the styler and warms every shape up
with one iteration per octave on the job's first two keyframes. The
window opens at the start of a job and closes at the end of the first job
that ends after ``--seconds`` (the styler yields frames only after its
last keyframe, so the job is the unit); an output frame counts when its
particles are on the host. With ``--trace 1`` one more job runs traced
with the card's activity alone, then its first two keyframes with the
host's operators too.

What is checked, on the first job: keyframe 0 (cold), keyframe k (k drawn
from the seed in 1..``kf_check_max``) and a frame t between keyframes
k - 1 and k, each worked out again by the plain reference from the same
inputs. Keyframe k starts from the program's keyframe k - 1, its param
recovered from that keyframe's output particles, and frame t
interpolates between that param and the reference's keyframe k. The gaps
of the output particles (positions and densities, against the
stylization's own change of them) and the widest relative gap of the
keyframes' per-iteration losses are compared.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import harness, inputs
from benchmark.harness import Check, Outcome
from benchmark.kinds.stream_grid import loss_gap


def particle_gap(got, want, base) -> float:
    """||got - want|| / ||want - base|| over positions and densities
    together; each argument an (x (N, 3), dens (N,)) pair."""
    num = sum(float(torch.sum((g.to(w.device) - w) ** 2))
              for g, w in zip(got, want))
    den = sum(float(torch.sum((w - b) ** 2)) for w, b in zip(want, base))
    return (num / den) ** 0.5


def keyframe_indices(T: int, stride: int) -> List[int]:
    kfs = list(range(0, T, stride))
    return kfs if kfs[-1] == T - 1 else kfs + [T - 1]


def lnst_least_s(sc: Dict, grid) -> float:
    """Least seconds of one keyframe's iterations: the coarse octaves
    render a grid, the finest splats the particles first (the splat's
    operations are elementwise and bound nothing)."""
    from benchmark.reference.tnst import octave_shapes
    from benchmark.roofline import counts

    total = 0.0
    for s in octave_shapes(grid, sc["optim.octave_n"],
                           sc["optim.octave_scale"]):
        scale = s[0] / grid[0]
        size = tuple(max(64, int(round(r * scale / 8)) * 8)
                     for r in sc["render.render_size"])
        total += sc["optim.iters"] * counts.tnst_iteration_least_s(
            s, size, sc["render.n_views"], 1, sc["loss.style_layers"])
    return total


def splat_least_s(sc: Dict, grid, n: int) -> float:
    """Least seconds of one keyframe's splats: the finest octave's
    forward (K4) and backward (K5) every iteration, and one forward at
    each coarse octave (its grid-space density)."""
    from benchmark.reference.tnst import octave_shapes
    from benchmark.roofline import counts

    shapes = octave_shapes(grid, sc["optim.octave_n"],
                           sc["optim.octave_scale"])
    cells = [int(np.prod(s)) for s in shapes]
    return (sum(counts.splat_least_s(c, n, False) for c in cells[:-1])
            + sc["optim.iters"] * (counts.splat_least_s(cells[-1], n, False)
                                   + counts.splat_least_s(cells[-1], n,
                                                          True)))


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
        sched = inputs.view_schedule(seed, j, len(kfs), octaves, iters, 1,
                                     sc["render.view_pool"])[..., 0]
        return xs, [ParticleSet(x=x, dens=ones) for x in xs], sched

    cfg = replace(StyleConfig(), seed=seed, **sc)
    styler = ParticleStyler(cfg, grid_shape=grid, vgg_params=vgg,
                            style_image=style, device=device)
    if faults:
        faults(styler)
    xs, psets, sched = job(0)
    # warm-up: one iteration per octave of the first two keyframes and the
    # frames between them
    warm = ParticleStyler(replace(cfg, **{"optim.iters": 1}), grid_shape=grid,
                          vgg_params=vgg, style_image=style, device=device)
    for _, ps in warm.stylize_keyframes(psets[:stride + 1],
                                        view_schedule=sched[:2, :, :1]):
        ps.x.cpu()
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
        _, jp, js = (xs, psets, sched) if j == 0 else job(j)
        for t, ps in styler.stylize_keyframes(jp, view_schedule=js):
            host = (ps.x.cpu(), ps.dens.cpu())
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
        summary["least_frame_s"] = len(kfs) * lnst_least_s(sc, grid) / F
        summary["splat_least_s"] = len(kfs) * splat_least_s(sc, grid, n)
    del styler
    harness.release(device)

    checks = check(sc, conf, seed, vgg, style, xs, sched, kfs, k, t_mid,
                   out, losses, overflow, mix["limits"], device)
    return Outcome(frames=frames, window_s=window_s, setup_s=setup_s,
                   peak_bytes=peak, failed=failed, checks=checks,
                   summary=summary)


def _traced(styler, data, stride, iters_per_kf, n_kf, device) -> Dict:
    """One job with the card's activity alone (device time, busy share,
    launch calls), then its first two keyframes with the host's
    operators too (the idle gaps' names)."""
    from torch.profiler import ProfilerActivity

    _, psets, sched = data

    def job(ps, sc):
        def step():
            for _, p in styler.stylize_keyframes(ps, view_schedule=sc):
                p.x.cpu()
        return step

    acts = [ProfilerActivity.CUDA]
    harness.warm_profiler(device)
    dev_events, wall = harness.trace(job(psets, sched), acts, device)
    host_events, _ = harness.trace(job(psets[:stride + 1], sched[:2]),
                                   acts + [ProfilerActivity.CPU], device)
    return harness.reduce_events(dev_events, wall, n_kf * iters_per_kf,
                                 len(psets), host_events)


def check(sc, conf, seed, vgg, style, xs, sched, kfs, k, t_mid, out,
          losses, overflow, limits, device) -> List[Check]:
    """The reference's keyframes 0 and k, and frame t_mid, beside the
    program's."""
    from benchmark.reference.lnst import Lnst

    ref = Lnst(sc, conf["grid"], vgg, style, seed, device=device)
    n = xs.shape[1]
    ones = torch.ones(n, device=device)
    thresh = 4 * int(sc["particle.k_budget"] * n)

    def got(t):
        return tuple(a.to(device) for a in out[t])

    def recovered(i):
        return ref.recover(xs[kfs[i]], ones, *got(kfs[i]))

    # the bin plan as the program keeps it: probed at the first keyframe,
    # probed again after a keyframe that parked more than 4x the budget
    plan0 = plan = ref.plan(xs[kfs[0]])
    for i in range(1, k + 1):
        if overflow[i - 1] > thresh:
            plan = ref.plan(ref.apply(xs[kfs[i]], ones,
                                      recovered(i - 1))[0])
    checks = []
    for name, i in (("kf0", 0), ("kf", k)):
        init = None if i == 0 else recovered(i - 1)
        p_ref, l_ref = ref.keyframe(xs[kfs[i]], ones, sched[i],
                                    plan0 if i == 0 else plan, init)
        want = ref.apply(xs[kfs[i]], ones, p_ref)
        checks.append(Check(f"{name}_gap", particle_gap(
            got(kfs[i]), want, (xs[kfs[i]], ones)), limits["kf_gap"]))
        checks.append(Check(f"{name}_loss_gap",
                            loss_gap(losses[kfs[i]], l_ref),
                            limits["kf_loss_gap"]))
    alpha = (t_mid - kfs[k - 1]) / (kfs[k] - kfs[k - 1])
    want = ref.apply(xs[t_mid], ones,
                     ref.lerp(recovered(k - 1), p_ref, alpha))
    checks.append(Check("interp_gap", particle_gap(
        got(t_mid), want, (xs[t_mid], ones)), limits["kf_gap"]))
    return checks
