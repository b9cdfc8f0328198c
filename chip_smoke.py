#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nfs_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line:

1. device  — needs ``torch.cuda.is_available()`` and the port
   (``nfs_tpu_torch``) beside the script; prints the card's name and the
   ``nvidia-smi`` name and power limit.
2. build   — compiles ``nfs_tpu_torch/csrc/advect.cu`` and
   ``binsplat.cu`` with nvcc for sm_90a and ``ops.cpp`` (the operators
   ``torch.ops.nfs_tpu_torch.*`` the wrappers launch through) with g++
   against torch's headers into ``build/nfs_tpu_torch/``, all three at
   once, links the operators to the kernels and loads them.
3. kernels — every kernel against its plain PyTorch version on the card,
   at the main paths' shapes: K1-K3b at 112x64x112 (random, clamped,
   integer-valued and zero velocities at max_disp 2 and 1, random at
   max_disp 3, the density slice's smooth swirl), K1, K2 and K3b also
   launched twice (bitwise equal) and K3b against K2 + K3 launched
   separately (exactly equal); K2's untiled pull against the tiled one
   at max_disp 2 and 8 (bitwise equal); past the tile plan (max_disp 9
   and 12, 112x64x112) K2's untiled route against its plain twin and
   K3b's route (K2 + K3) against K2 and K3; K4-K5 on the particle path's
   finest octave (200 000 particles of the particles_3d bench binned at
   96x64x96 with the styler's own capacity K: as binned, drifted +-0.5
   cell, crowded past K = 2, integer positions), K5 also on the coarsest
   octave's bins (30x20x30, its planned K), K4 also launched twice
   (bitwise equal). Each kernel, its plain
   version and the one PyTorch library call that computes the same
   function, where there is one, are timed: ``ms`` is the median of 30
   single calls between two CUDA events (the host's work to launch
   included), ``device_ms`` the median of 30 runs of 10 calls queued
   behind a device sleep (device time only), ``host_us`` the host's
   microseconds per call of the kernel's wrapper or the library call
   (100 calls behind a device sleep, median of 5 batches: the checks,
   allocation and launch alone); K2 and K3b also at max_disp 3 and on
   the swirl, the untiled pull at max_disp 9 and 12, K5 also at the
   coarsest octave.
   kernels_batched — K1, K2 (tiled, and untiled at max_disp 9), K3 and
   K3b on a batch of 4 frames at 112x64x112: one launch, bitwise the 4
   single launches, against the batched plain twin at the same
   tolerance; the batched call's ``ms`` and ``device_ms`` beside the 4
   single calls'.
   bin_kernels_batched — K4 and K5 on a batch of 4 keyframes' finest-
   octave bins (the particles_3d particles of four seeds at 96x64x96,
   the planned K): one launch each, bitwise the 4 single launches,
   against the batched plain twins; timed beside the 4 single calls.
   reference — small runs of the grid and particle slices on the GPU
   against the same runs on the CPU (plain versions; the CPU port is held
   against the JAX package by the tests).
4. density — the grid styler's streaming sequence path at config #3
   widths with the window-transport loss (W=1): 3 frames of 112x64x112
   through ``FrameStore`` and ``GridStyler.stylize_sequence``.
5. velocity — the velocity parameterization (config #4), one frame, W=1.
6. fused_bwd_ab — 50 chained descent steps of sum(advect(f, v)^2) with
   gradients in f and v at 112x64x112 (bench/advect_bench.py's chain), ms
   per step with ``FUSED_BWD`` off (K2 + K3) and on (K3b): K3b's path.
7. velocity again with ``FUSED_BWD``: each advection there needs one
   gradient, so the same K2 and K3 launches as phase 5 and no K3b, losses
   equal to phase 5's within rtol 1e-5.
   far — the density slice's first frame with ``optim.max_disp`` 9 (K2's
   untiled pull, R = 9), held against the same frame at max_disp 2.
8. particle — the LNST path at the particles_3d bench widths:
   ``ParticleStyler.stylize_keyframes`` over 11 frames of 200 000
   particles on a 96x64x96 grid (keyframes 0 and 10), 3 octaves x 20
   iterations, 9 views at 256^2.
9. profile (only with ``--profile``; the keyframes phase then also traces
   its five keyframes) — the density slice at config #3's
   20 iterations per octave: steady seconds per iteration and per frame,
   then two frames under ``torch.profiler`` for the device's kernel time
   per iteration by category and its idle share in that traced run; then
   keyframe 10 of the particle phase under ``torch.profiler`` the same
   way.
10. scene — ``nfs_tpu_torch.cli.scene`` writes smoke3d at 112x64x112 (16
    frames, exactly 7 K1 launches per solver step) and liquid3d at 64^3
    (8 frames, 72 500 particles).
11. northstar — the north-star data path of bench/northstar.py at 16
    frames: ``smoke_sequence_cached`` into a chunk directory, then
    ``iter_sequence_blocks`` into ``stylize_sequence_blocks(fused=4)`` at
    config #3 widths (5 iterations per octave), frames 0-7 held against
    the streaming path.
12. cli — ``cli.stylize --fused 2`` over 4 of the scene's frames, then a
    rerun that the complete manifest turns into a no-op; then
    ``cli.stylize --parallel --mode particle`` over 3 particles_3d frames
    (keyframes 0 and 2 through the keyframe engine).
    parallel — the joint sequence engine (``ParallelSequenceStyler``) on
    a (1, 1) mesh at the density slice's config over 8 of the scene's
    frames: s/iter, s/frame and peak memory; 2 K1 and 2 K2 launches per
    iteration at T = 8 and at T = 2 (the frame batch reaches the
    kernels); the same run inside a 1-rank NCCL process group, bitwise;
    the streaming styler on the same frames (s/frame); the first
    iteration on the card against the CPU port; config #4 through the
    engine (K1, K2, K3 batched); one ``cli.stylize --parallel`` run.
    keyframes — the keyframe-parallel LNST engine
    (``ParallelKeyframeStyler``) on a (1, 1) mesh at the full
    particles_3d width over 41 frames: keyframes 0, 10, 20, 30 and 40 in
    one program (s per keyframe, s per output frame, peak memory; its K4
    and K5 launches must equal one independent keyframe's), held within
    rtol 4e-3 / atol 4e-4 of the five keyframes run as independent
    ``stylize_frame`` calls (timed beside it), inside a 1-rank NCCL group
    (bitwise), and small 3D colour and 2D keyframe runs against the CPU
    port.
13. 2d — BASELINE config #1 (a 256x192 frame, bf16, 3 octaves x 30
    iterations), the 512^2 headline shape (3 x 10) and config #2 (a
    256x192 smoke_sequence, W=1, 2 x 20, 6 frames) through GridStyler,
    s/iter and s/frame; a small 2D GPU-against-CPU comparison.
14. transfer_gather — the density slice's first frame coloured by a
    trained 'fire' transfer function, with the shear rotation and then
    with rotation='gather'.
15. color — LNST colour at the particles_3d width on one keyframe (3 x 4
    iterations), the binned 5-channel colour pass timed alone, and a 2D
    particle run on the scene CLI's liquid2d frames.
    spatial — spatial sharding at the density slice's width:
    ``SpaceSlabs.advect`` (K1 with K2, K3, K3b, and a batch of two frames)
    on the y-slabs of 2 and 4 space ranks, run one after another in one
    process (``run_slabs``), against ``advect`` on the whole volume (the
    output and the velocity gradient bitwise, the field gradient, halo
    rows returned to their owners, within ``SLAB_TOL``; one launch per
    slab and kernel); then, inside a 1-rank NCCL group,
    ``stylize_frame_spatial`` (W = 1, and the velocity parameterization)
    bitwise ``stylize_frame``, with s/iter and peak memory beside
    ``persistent_state_bytes``, and the engine on a (1, 1, 1) mesh
    bitwise the (1, 1) one (both one slab: one code path). Runs after
    keyframes.
16. checkpoint — the velocity slice's first frame interrupted after a
    chunk of octave 1 and resumed from its in-frame checkpoint, held
    against two uninterrupted runs; the same frame at float32 features
    (cuDNN's default convolutions differ run to run there): s/iter with
    the default algorithms and inside the styler's deterministic scope,
    and an interrupted, resumed checkpointed frame held bitwise to an
    uninterrupted one; a ``--checkpoint_in_frame`` CLI job
    that completes and leaves no checkpoint.
17. exact — the exact advection path (max_disp=None) at 112x64x112 on
    the swirl and on a velocity of up to 6 cells: ``advect`` and
    ``advect_maccormack`` with both gradients on the card against the
    CPU port, timed beside K1 and K1 + K2; a density sequence and a
    velocity frame with optim.max_disp and param_max_disp None (no K1-K3
    launch allowed). Runs after transfer_gather.
18. remat — the density slice's frame 0 at 512^2 renders without and
    with ``loss.remat_views``: peak device memory and s/iter of each;
    the peak with remat must be the lower.
19. serve — the stylization service in-process over the scene's smoke3d
    frames at the density slice's config: a grid job, the same job again
    (both caches hit, equal output), once more under
    ``utils.profiling.trace`` (the trace must hold K1), a particle job
    at the particles_3d width, a "parallel" grid job (the joint engine)
    and a "parallel" particle job (the keyframe engine), each held
    against the same job on a CPU worker, then the stop marker.
20. render_quality — ``cli.render`` over the served grid (grey and
    'fire') and particle outputs; ``eval``'s metrics of the served and
    raw frames; the density slice's FLOPs per iteration and MFU against
    the H100's dense bf16 peak.

Then the script's whole time, one JSON line with every kernel's route,
error, launches on its main path, times and least time on the card (the
advection kernels also with their batch of 4 and their launches on the
joint engine's and the spatial path, K4 and K5 with their keyframe batch
of 4 and their launches on the keyframe engine's path), and as the last
line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, so the exit code is non-zero and no result is printed.
Weights (VGG), style image and data are random, made from fixed seeds.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SHAPE = (112, 64, 112)
KERNELS = (
    # launch key, name, TPU kernel it replaces
    ("fwd", "advect_fwd (K1)", "nfs_tpu/ops/pallas_advect.py:45"),
    ("bwd_field", "advect_bwd_field (K2)",
     "nfs_tpu/ops/pallas_advect.py:148"),
    ("bwd_vel", "advect_bwd_vel (K3)", "nfs_tpu/ops/pallas_advect.py:203"),
    ("bwd_fused", "advect_bwd_fused (K3b)",
     "nfs_tpu/ops/pallas_advect.py:301"),
)
UNTILED = ("bwd_field_untiled", "advect_bwd_field_untiled (K2, R > 8)",
           "nfs_tpu/ops/pallas_advect.py:148")
TOL = {"fwd": 1e-5, "bwd_field": 1e-4, "bwd_vel": 1e-4, "bwd_fused": 1e-4}
# K2 past its tile plan: max_disp 9 and 12 (R = 9, 12)
FAR_MAX_DISP = (9.0, 12.0)
BIN_KERNELS = (
    ("fwd", "binsplat_fwd (K4)", "nfs_tpu/ops/pallas_binsplat.py:125"),
    ("bwd", "binsplat_bwd (K5)", "nfs_tpu/ops/pallas_binsplat.py:248"),
)
# values against sums of the same terms in another order; K5's position
# gradients are sums of 27 products of O(1) weights and O(1) cotangents
BIN_TOL = {"fwd": 1e-5, "bwd": 1e-4}

# The particles_3d bench (bench/full_bench.py:194-230): 200 000 particles
# uniform on [8, 88) x [8, 56) x [8, 88) of a 96x64x96 grid
P_GRID = (96, 64, 96)
P_COUNT = 200_000

# cli.scene's liquid3d scene at 64^3 (8 frames)
LIQUID_GRID = (64, 64, 64)

# least time on the card: the H100 SXM's 3.35 TB/s HBM and 67 TFLOP/s
# float32 outside the tensor cores (NVIDIA's H100 SXM datasheet)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# float32 operations each kernel's function needs per element: K1 one
# clamped backtrace (12) and 8 trilinear corner terms (13 each); K2 its
# adjoint, the same per source cell; K3 27 taps of 3 derivative products
# (10 each) plus the backtrace; K3b K2's and K3's together; K4 per
# OCCUPIED slot 3 fracs (2), 9 weights (4) and 27 taps (4), empty slots
# being skipped; K5 per slot the same fracs and weights, 9 derivatives
# (4) and 27 taps of 4 sums (16)
OPS_PER_ELEMENT = {"fwd": 116, "bwd_field": 116, "bwd_vel": 282,
                   "bwd_fused": 116 + 282,
                   "binsplat_fwd": 150, "binsplat_bwd": 513}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return kind, card


def phase_build():
    """The two kernel libraries (one nvcc each) and the operator library
    (g++ against torch's headers), the three compiles started together,
    then linked and loaded."""
    from nfs_tpu_torch.ops import _cuda_build

    t0 = time.perf_counter()
    ops = _cuda_build.build_operators()
    _cuda_build.load_operators()
    libs = [_cuda_build.library_path(_cuda_build.CSRC / src, stem)
            for src, stem in _cuda_build.KERNEL_SOURCES] + [ops]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(so) for so in libs]})


def _bound(nbytes: float, ops: float):
    """(least ms on the card, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _kernel_inputs(case: str, max_disp: float, seed: int):
    """Seeded field, cotangent and displacement. 'random' velocities are
    normal with sigma = max_disp / 1.2816, so ~20% of the components
    exceed max_disp and get clamped; 'swirl' is the density slice's
    smooth swirl (|v| <= 1.5)."""
    rng = np.random.default_rng(seed)
    f = rng.random(SHAPE, dtype=np.float32)
    g = rng.standard_normal(SHAPE, dtype=np.float32)
    v = (max_disp / 1.2816) * rng.standard_normal(SHAPE + (3,),
                                                  dtype=np.float32)
    if case == "integer":
        v = np.round(v)
    elif case == "zero":
        v = np.zeros_like(v)
    elif case == "swirl":
        v = _swirl_velocity(SHAPE, 0)
    return f, g, v


def _median_ms(fn, runs: int = 30) -> float:
    """Median of ``runs`` single calls of ``fn``, each between two CUDA
    events on an idle device: the host's work up to the launch is timed
    with the device's."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, runs: int = 30, reps: int = 10) -> float:
    """Median over ``runs`` of the time per call of ``reps`` calls of
    ``fn`` between two CUDA events, each run queued behind a device sleep
    (~1 ms), so the device finds the calls queued and the events time the
    device only. A function whose host work per call exceeds its device
    time (the plain versions' many small launches) still shows the
    host's."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _host_us(fn, calls: int = 100, batches: int = 5) -> float:
    """Host microseconds per call of ``fn`` (the wrapper's checks,
    allocation and launch): the median over ``batches`` of ``calls`` calls
    timed with ``perf_counter_ns`` while the device is held behind a
    device sleep, so that no call waits on the device. A batch that the
    device caught up with is run again behind a sleep twice as long."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    cycles, per_call = 50_000_000, []
    while len(per_call) < batches:
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter_ns()
        caught_up = stream.query()
        torch.cuda.synchronize()
        if not caught_up:
            per_call.append((t1 - t0) / calls / 1e3)
        elif cycles < 2_000_000_000:
            cycles *= 2
        else:
            raise AssertionError("the device caught up with the host even "
                                 "behind a 1 s sleep")
    return statistics.median(per_call)


def _max_err(a, b) -> float:
    """Largest |a - b| over a tensor or over the tensors of a tuple."""
    if isinstance(a, tuple):
        return max(_max_err(x, y) for x, y in zip(a, b))
    return float((a - b).abs().max())


def _all_finite(a) -> bool:
    import torch

    parts = a if isinstance(a, tuple) else (a,)
    return all(bool(torch.isfinite(x).all()) for x in parts)


def _cuda_inputs(case: str, max_disp: float, seed: int):
    import torch

    dev = torch.device("cuda", 0)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in _kernel_inputs(case, max_disp, seed))


def _advect_pairs():
    """(kernel, plain version) of K1-K3b, each called as fn(f, g, v,
    max_disp)."""
    from nfs_tpu_torch.ops import advect_kernels as ak

    return {
        "fwd": (lambda f, g, v, d: ak.advect_fwd(f, v, d),
                lambda f, g, v, d: ak.advect_fwd_plain(f, v, d)),
        # K2's wrapper takes the untiled pull past the tile plan (R > 8)
        "bwd_field": (lambda f, g, v, d: ak.advect_bwd_field(v, g, d),
                      lambda f, g, v, d: ak.advect_bwd_field_plain(v, g, d)),
        "bwd_vel": (lambda f, g, v, d: ak.advect_bwd_vel(f, v, g, d),
                    lambda f, g, v, d: ak.advect_bwd_vel_plain(f, v, g, d)),
        "bwd_fused": (
            lambda f, g, v, d: ak.advect_bwd_fused(f, v, g, d),
            lambda f, g, v, d: ak.advect_bwd_fused_plain(f, v, g, d)),
    }


def _equal(a, b) -> bool:
    import torch

    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def phase_kernels(card: str):
    """K1-K3b against the plain twins on the card; K2 and K3b launched
    twice must agree bitwise, and K3b must equal K2 + K3 launched
    separately exactly. Returns the per-kernel records of the final JSON
    line (launches are filled in later)."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak

    pairs = _advect_pairs()
    errs = {k: 0.0 for k in pairs}
    cases = [("random", 2.0), ("random", 1.0), ("integer", 2.0),
             ("zero", 1.0), ("random", 3.0), ("swirl", 2.0)]
    for n, (case, md) in enumerate(cases):
        f, g, v = _cuda_inputs(case, md, seed=n)
        case_err = {}
        for key, (kern, plain) in pairs.items():
            out_k = kern(f, g, v, md)
            out_p = plain(f, g, v, md)
            torch.cuda.synchronize()
            if not _all_finite(out_k):
                raise AssertionError(f"{key}: non-finite output ({case})")
            err = _max_err(out_k, out_p)
            case_err[key] = err
            if not err <= TOL[key]:
                raise AssertionError(
                    f"{key} disagrees with its plain twin on case "
                    f"{case} max_disp={md}: {err} > {TOL[key]}")
            errs[key] = max(errs[key], err)
            # K1 and the pull kernels are deterministic: no atomics
            if key in ("fwd", "bwd_field", "bwd_fused") and not _equal(
                    out_k, kern(f, g, v, md)):
                raise AssertionError(f"{key}: two launches differ on case "
                                     f"{case} max_disp={md}")
        # K3b against K2 and K3 launched separately on the same inputs:
        # the same sums term for term
        split_err = _max_err(ak.advect_bwd_fused(f, v, g, md),
                             (ak.advect_bwd_field(v, g, md),
                              ak.advect_bwd_vel(f, v, g, md)))
        if split_err != 0.0:
            raise AssertionError(f"K3b differs from K2 + K3 on case "
                                 f"{case} max_disp={md}: {split_err}")
        emit({"phase": "kernels", "case": case, "max_disp": md,
              "max_abs_err": case_err, "k3b_vs_k2_k3": split_err,
              "bitwise_repeat": True, "tol": TOL})
    # K2's untiled pull, launched through its operator, gives the tiled
    # pull's bits wherever the tile plan reaches (R = 2 and its last, 8)
    for md in (2.0, 8.0):
        f, g, v = _cuda_inputs("random", md, seed=7)
        if not _equal(_untiled(v, g, md), ak.advect_bwd_field(v, g, md)):
            raise AssertionError(f"K2 untiled differs from tiled at "
                                 f"max_disp {md}")
        emit({"phase": "kernels", "case": "random", "max_disp": md,
              "k2_untiled_vs_tiled": "bitwise equal"})

    # times at the main path's shape: K1/K2 as the window loss runs them
    # (max_disp 2), K3 as the velocity parameter runs it (max_disp 1), K3b
    # as the fused-backward A/B runs it (max_disp 2). Least bytes: each
    # input read once, each output written once (K3b: vel, g and f in,
    # grad_f and grad_s out, 9 floats per cell)
    records = []
    for key, name, replaces in KERNELS:
        md = 1.0 if key == "bwd_vel" else 2.0
        t = _time_advect(key, "random", md, card)
        records.append({"name": name, "route": "cuda",
                        "source": "nfs_tpu_torch/csrc/advect.cu",
                        "replaces": replaces, "launches": None,
                        "max_abs_err": errs[key], **t})
    # the pull kernels also at max_disp 3 (R = 3) and on the smooth swirl
    # the density slice advects with
    for key in ("bwd_field", "bwd_fused"):
        for case, md in (("random", 3.0), ("swirl", 2.0)):
            _time_advect(key, case, md, card)
    return records


def _time_advect(key: str, case: str, md: float, card: str,
                 name: str | None = None) -> dict:
    """Kernel, plain version and library call of one advection kernel on
    seed-99 inputs at SHAPE, each timed with :func:`_median_ms`, the
    kernel and the library call also with :func:`_device_ms` and
    :func:`_host_us`, and the least time; emits a kernel_time line under
    ``name`` (the kernel's record name by default) and returns its
    numbers."""
    kern, plain = _advect_pairs()[key]
    f, g, v = _cuda_inputs(case, md, seed=99)
    n = math.prod(SHAPE)
    io_floats = {"fwd": 5 * n, "bwd_field": 5 * n, "bwd_vel": 8 * n,
                 "bwd_fused": 9 * n}
    library = _advect_library_call(key, f, g, v, md)
    t = {"ms": _median_ms(lambda: kern(f, g, v, md)),
         "plain_ms": _median_ms(lambda: plain(f, g, v, md)),
         "library_ms": _median_ms(library),
         "device_ms": _device_ms(lambda: kern(f, g, v, md)),
         "library_device_ms": _device_ms(library),
         "host_us": _host_us(lambda: kern(f, g, v, md)),
         "library_host_us": _host_us(library)}
    t["bound_ms"], t["bound_by"] = _bound(4 * io_floats[key],
                                          OPS_PER_ELEMENT[key] * n)
    name = name or next(nm for k, nm, _ in KERNELS if k == key)
    emit({"phase": "kernel_time", "kernel": name, "inputs": case,
          "max_disp": md, "shape": list(SHAPE), **t, "card": card})
    return t


# The frame batch of the batched kernel phase, and its cases: (key of
# the record, launch key, max_disp). K2 at max_disp 9 takes the untiled
# pull.
BATCH = 4
BATCH_CASES = (("fwd", "fwd", 2.0), ("bwd_field", "bwd_field", 2.0),
               ("bwd_field_untiled", "bwd_field_untiled", 9.0),
               ("bwd_vel", "bwd_vel", 1.0), ("bwd_fused", "bwd_fused", 2.0))


def phase_batched_kernels(card: str):
    """K1, K2 (tiled, and untiled at max_disp 9), K3 and K3b on a batch of
    BATCH frames at SHAPE: the batched call is one launch and gives the
    BATCH single launches' bits, and holds against the batched plain twin
    at TOL. Times the batched call (``ms``, ``device_ms``) beside the
    BATCH single calls it replaces. Returns {record key: numbers}."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak

    pairs = _advect_pairs()
    out = {}
    for rec_key, key, md in BATCH_CASES:
        kern, plain = pairs["bwd_field" if key.startswith("bwd_field")
                            else key]
        inputs = [_cuda_inputs("random", md, seed=40 + b)
                  for b in range(BATCH)]
        f, g, v = (torch.stack(x) for x in zip(*inputs))
        before = ak.LAUNCHES[key]
        batched = kern(f, g, v, md)
        one_launch = ak.LAUNCHES[key] - before
        singles = [kern(*x, md) for x in inputs]
        single_launches = ak.LAUNCHES[key] - before - one_launch
        single = (tuple(torch.stack(o) for o in zip(*singles))
                  if isinstance(batched, tuple) else torch.stack(singles))
        err = _max_err(batched, plain(f, g, v, md))
        torch.cuda.synchronize()
        tol = TOL["bwd_field" if key.startswith("bwd_field") else key]
        if (one_launch, single_launches) != (1, BATCH):
            raise AssertionError(f"{rec_key}: a batch of {BATCH} took "
                                 f"{one_launch} launches, {BATCH} frames "
                                 f"{single_launches}")
        if not _equal(batched, single):
            raise AssertionError(f"{rec_key}: the batched launch differs "
                                 f"from {BATCH} single launches")
        if not (_all_finite(batched) and err <= tol):
            raise AssertionError(f"{rec_key}: batched kernel against its "
                                 f"batched plain twin: {err} > {tol}")
        # the untiled pull takes ~7 ms a frame: fewer timing runs
        runs, reps = (5, 2) if key == "bwd_field_untiled" else (30, 10)
        t = {"ms": _median_ms(lambda: kern(f, g, v, md), runs),
             "single_x4_ms": _median_ms(
                 lambda: [kern(*x, md) for x in inputs], runs),
             "device_ms": _device_ms(lambda: kern(f, g, v, md), runs, reps),
             "single_x4_device_ms": _device_ms(
                 lambda: [kern(*x, md) for x in inputs], runs, reps),
             "launches": one_launch, "single_launches": single_launches,
             "max_abs_err": err}
        emit({"phase": "kernels_batched", "kernel": rec_key, "batch": BATCH,
              "shape": list(SHAPE), "max_disp": md, "tol": tol,
              "bitwise_vs_single": True, **t, "card": card})
        out[rec_key] = t
    return out


def _untiled(v, g, md):
    """K2's untiled pull launched through its operator at any radius
    (not counted: the wrapper counts its own launches)."""
    from nfs_tpu_torch.ops import advect_kernels as ak

    return ak.load_library().advect_bwd_field_untiled(v, g, md,
                                                      ak._radius(md))


def phase_far_kernels(card: str):
    """K2 past its tile plan (max_disp 9 and 12) at the main path's shape:
    the wrapper's untiled pull against the plain twin, launched twice
    bitwise equal; K3b's wrapper there (K2 + K3) against K2 and K3
    launched separately (exactly equal) and against its plain version;
    then the untiled pull timed at both. Returns its record at max_disp
    9."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak

    kern, plain = _advect_pairs()["bwd_field"]
    key, name, replaces = UNTILED
    err = 0.0
    for n, md in enumerate(FAR_MAX_DISP):
        f, g, v = _cuda_inputs("random", md, seed=20 + n)
        before = ak.LAUNCHES[key]
        out = kern(f, g, v, md)
        if ak.LAUNCHES[key] != before + 1:
            raise AssertionError(f"max_disp {md}: K2 did not take its "
                                 f"untiled route")
        e = _max_err(out, plain(f, g, v, md))
        fused = ak.advect_bwd_fused(f, v, g, md)
        split_err = _max_err(fused, (out, ak.advect_bwd_vel(f, v, g, md)))
        fused_err = _max_err(fused, ak.advect_bwd_fused_plain(f, v, g, md))
        torch.cuda.synchronize()
        if not (_all_finite(out) and e <= TOL["bwd_field"]
                and fused_err <= TOL["bwd_fused"]):
            raise AssertionError(f"max_disp {md}: K2 untiled err {e}, K3b "
                                 f"route err {fused_err}")
        if split_err != 0.0 or not _equal(out, kern(f, g, v, md)):
            raise AssertionError(f"max_disp {md}: K3b's route differs from "
                                 f"K2 + K3 ({split_err}) or two launches "
                                 f"differ")
        err = max(err, e)
        emit({"phase": "kernels", "case": "random", "shape": list(SHAPE),
              "max_disp": md, "max_abs_err": {key: e, "bwd_fused": fused_err},
              "k3b_route_vs_k2_k3": split_err, "bitwise_repeat": True,
              "tol": TOL})
    times = [_time_advect("bwd_field", "random", md, card, name=name)
             for md in FAR_MAX_DISP]
    return {"name": name, "route": "cuda",
            "source": "nfs_tpu_torch/csrc/advect.cu", "replaces": replaces,
            "launches": None, "max_abs_err": err, **times[0],
            "max_disp": FAR_MAX_DISP[0],
            "at_max_disp_12": {k: times[1][k] for k in
                               ("ms", "device_ms", "plain_ms", "library_ms")}}


def _advect_library_call(key, f, g, v, md):
    """The one PyTorch call computing K1's function (``F.grid_sample`` at
    the clamped backtrace, zero padding, align_corners) or its backward,
    ``aten.grid_sampler_3d_backward``: asked for the input gradient alone
    for K2 (either route), for both gradients for K3 and K3b. A yardstick
    only: the port never calls it."""
    import torch
    import torch.nn.functional as F

    from nfs_tpu_torch.ops import advect_kernels as ak

    s = ak.backtrace(v, md)
    # normalised (x, y, z) sample grid, align_corners=True
    grid = torch.stack([2.0 * s[a] / (f.shape[a] - 1) - 1.0
                        for a in (2, 1, 0)], dim=-1)[None].contiguous()
    inp = f[None, None]
    if key == "fwd":
        return lambda: F.grid_sample(inp, grid, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=True)
    gout = g[None, None]
    mask = [True, key != "bwd_field"]
    return lambda: torch.ops.aten.grid_sampler_3d_backward(
        gout, inp, grid, 0, 0, True, mask)


def _bin_inputs(case: str, K: int, seed: int, grid=P_GRID):
    """The window operands of an octave of grid ``grid`` (the finest by
    default) for the particles_3d bench particles, scaled to it as the
    styler scales them: (a, p_z, p_y, p_x) as (K, Zp, Yp, Xp) CUDA
    tensors, the cotangent g (Zp, Yp, Xp), the occupied slots and the
    parked particles."""
    import torch

    from nfs_tpu_torch.ops import binsplat as B

    rng = np.random.default_rng(seed)
    x = _bench_particles(rng)
    if case == "crowded":      # a tenth of them in one cell: parked
        x[: P_COUNT // 10] = 40.0 + 0.05 * rng.random((P_COUNT // 10, 3))
    elif case == "integer":    # integers and half-integers: _dw1d's ties
        x = np.round(2.0 * x) / 2.0
    dev = torch.device("cuda", 0)
    xt = torch.from_numpy(x).to(dev) * (grid[0] / P_GRID[0])
    bn = B.bin_particles(xt, grid, K)
    if case == "drifted":
        xt = xt + torch.from_numpy(rng.uniform(
            -0.5, 0.5, x.shape).astype(np.float32)).to(dev)
    pshape = B.padded_shape(grid)
    n_slots = bn.valid.shape[0]
    p_b = B.to_binned(bn, xt)
    a_b = B.to_binned(bn, torch.from_numpy(
        (0.5 + rng.random(P_COUNT)).astype(np.float32)).to(dev))
    a4 = torch.where(bn.valid, a_b[:n_slots], 0.0).view((K,) + pshape)
    p4 = [p_b[d, :n_slots].view((K,) + pshape) for d in range(3)]
    g = torch.from_numpy(rng.standard_normal(pshape, dtype=np.float32)
                         ).to(dev)
    return a4, p4, g, int(bn.valid.sum()), int(bn.n_overflow)


def _sectors(t, index) -> int:
    """The 32-byte sectors of the contiguous float32 tensor ``t`` that
    hold at least one of its elements at the flat ``index``."""
    import torch

    lead = (t.data_ptr() % 32) // 4
    return int(torch.unique((index + lead) // 8).numel())


def _bench_particles(rng) -> np.ndarray:
    return (rng.random((P_COUNT, 3)) * np.array([80, 48, 80])
            + np.array([8, 8, 8])).astype(np.float32)


def _live_slots(p4) -> int:
    """Slots that some tap of K5 reaches: frac in (-1.5, 3.5) on every
    axis (binsplat.cu)."""
    from nfs_tpu_torch.ops import binsplat_kernels as bk

    live = None
    for f in bk._fracs(*p4):
        ok = (f > -1.5) & (f < 3.5)
        live = ok if live is None else live & ok
    return int(live.sum())


def phase_bin_kernels(card: str, K: int, coarse):
    """K4 and K5 against their plain versions on the particle path's
    finest-octave operands, K5 also on the coarsest octave's (``coarse``:
    its grid and the K the styler plans for it); then timed on the
    'binned' case, K5 at both octaves."""
    import torch

    from nfs_tpu_torch.ops import binsplat_kernels as bk

    errs = {"fwd": 0.0, "bwd": 0.0}
    for n, case in enumerate(("binned", "drifted", "crowded", "integer")):
        k = 2 if case == "crowded" else K
        a4, p4, g, occupied, parked = _bin_inputs(case, k, seed=n)
        out = bk.binsplat_fwd(a4, *p4)
        # K4 pulls without atomics: two launches agree bitwise
        if not _equal(out, bk.binsplat_fwd(a4, *p4)):
            raise AssertionError(f"binsplat fwd: two launches differ on "
                                 f"case {case}")
        case_err = {
            "fwd": float((out - bk.window_fwd_plain(a4, *p4)).abs().max()),
            "bwd": _max_err(bk.binsplat_bwd(a4, *p4, g),
                            bk.window_bwd_plain(a4, *p4, g))}
        torch.cuda.synchronize()
        for key, err in case_err.items():
            if not err <= BIN_TOL[key]:   # also catches NaN
                raise AssertionError(
                    f"binsplat {key} disagrees with its plain version on "
                    f"case {case}: {err} > {BIN_TOL[key]}")
            errs[key] = max(errs[key], err)
        emit({"phase": "kernels", "case": case, "K": k,
              "occupied_slots": occupied, "parked": parked,
              "live_slots": _live_slots(p4), "max_abs_err": case_err,
              "fwd_bitwise_repeat": True, "tol": BIN_TOL})

    grid_c, K_c = coarse
    coarse_in = _bin_inputs("binned", K_c, seed=98, grid=grid_c)
    a4, p4, g = coarse_in[:3]
    err = _max_err(bk.binsplat_bwd(a4, *p4, g),
                   bk.window_bwd_plain(a4, *p4, g))
    if not err <= BIN_TOL["bwd"]:
        raise AssertionError(f"binsplat bwd disagrees with its plain "
                             f"version at the coarsest octave: {err}")
    errs["bwd"] = max(errs["bwd"], err)
    emit({"phase": "kernels", "case": "binned, coarsest octave",
          "grid": list(grid_c), "K": K_c, "occupied_slots": coarse_in[3],
          "parked": coarse_in[4], "live_slots": _live_slots(p4),
          "slots": a4.numel(), "max_abs_err": {"bwd": err}, "tol": BIN_TOL})

    finest = _bin_inputs("binned", K, seed=99)
    records = []
    for key, name, replaces in BIN_KERNELS:
        t = _time_bins(key, finest, card)
        records.append({"name": name, "route": "cuda",
                        "source": "nfs_tpu_torch/csrc/binsplat.cu",
                        "replaces": replaces, "launches": None,
                        "max_abs_err": errs[key], **t})
    coarsest = _time_bins("bwd", coarse_in, card)
    records[-1]["coarsest_octave"] = {
        "grid": list(grid_c), "K": K_c,
        **{k: coarsest[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "device_ms", "host_us")}}
    return records


def _time_bins(key: str, inputs, card: str) -> dict:
    """K4 (``key`` 'fwd') or K5 ('bwd') and its plain version on one
    octave's bins, each timed with :func:`_median_ms`, the kernel also
    with :func:`_device_ms` and :func:`_host_us`, and the least time;
    emits a kernel_time line and returns the numbers. Least bytes: each
    input the function needs read once, each output written once. K4's
    sum does not depend on an empty slot's (a == 0) positions, so it
    needs a of every slot but the positions only in the 32-byte sectors
    that hold an occupied slot; K5's da of an empty slot does depend on
    its positions, so it needs them all."""
    from nfs_tpu_torch.ops import binsplat_kernels as bk

    a4, p4, g, occupied, _ = inputs
    slots, cells = a4.numel(), g.numel()
    if key == "fwd":
        kern = lambda: bk.binsplat_fwd(a4, *p4)     # noqa: E731
        plain = lambda: bk.window_fwd_plain(a4, *p4)     # noqa: E731
        occ = (a4 != 0).reshape(-1).nonzero().squeeze(1)
        pos_sectors = sum(_sectors(p, occ) for p in p4)
        work = (4 * (slots + cells) + 32 * pos_sectors,
                OPS_PER_ELEMENT["binsplat_fwd"] * occupied)
    else:
        kern = lambda: bk.binsplat_bwd(a4, *p4, g)     # noqa: E731
        plain = lambda: bk.window_bwd_plain(a4, *p4, g)     # noqa: E731
        work = (4 * (8 * slots + cells),
                OPS_PER_ELEMENT["binsplat_bwd"] * slots)
    t = {"ms": _median_ms(kern), "plain_ms": _median_ms(plain),
         "device_ms": _device_ms(kern), "host_us": _host_us(kern)}
    t["bound_ms"], t["bound_by"] = _bound(*work)
    t.update(library_ms=None, library_device_ms=None, library_host_us=None)
    name = next(nm for k, nm, _ in BIN_KERNELS if k == key)
    emit({"phase": "kernel_time", "kernel": name, "K": a4.shape[0],
          "padded_grid": list(g.shape), "occupied_slots": occupied,
          "live_slots": _live_slots(p4), **t, "least_bytes": work[0],
          "card": card})
    return t


def phase_bin_kernels_batched(card: str, K: int):
    """K4 and K5 on a batch of BATCH keyframes' finest-octave bins (the
    particles_3d bench particles of four seeds binned at 96x64x96 with
    the planned K): the batched call is one launch and gives the BATCH
    single launches' bits, and holds against the batched plain twins at
    BIN_TOL. Times the batched call (``ms``, ``device_ms``) beside the
    BATCH single calls it replaces, with the batch's least time. Returns
    {launch key: numbers}."""
    import torch

    from nfs_tpu_torch.ops import binsplat_kernels as bk

    inputs = [_bin_inputs("binned", K, seed=60 + b) for b in range(BATCH)]
    a5 = torch.stack([x[0] for x in inputs])
    p5 = [torch.stack([x[1][d] for x in inputs]) for d in range(3)]
    g5 = torch.stack([x[2] for x in inputs])
    singles = [(x[0], x[1], x[2]) for x in inputs]
    calls = {
        "fwd": (lambda: bk.binsplat_fwd(a5, *p5),
                lambda: [bk.binsplat_fwd(a, *p) for a, p, _ in singles],
                lambda: bk.window_fwd_plain(a5, *p5)),
        "bwd": (lambda: bk.binsplat_bwd(a5, *p5, g5),
                lambda: [bk.binsplat_bwd(a, *p, g) for a, p, g in singles],
                lambda: bk.window_bwd_plain(a5, *p5, g5)),
    }
    occupied = sum(x[3] for x in inputs)
    slots, cells = a5.numel(), g5.numel()
    out = {}
    for key, (batched_call, single_calls, plain) in calls.items():
        before = bk.LAUNCHES[key]
        batched = batched_call()
        one_launch = bk.LAUNCHES[key] - before
        single = single_calls()
        single_launches = bk.LAUNCHES[key] - before - one_launch
        single = (tuple(torch.stack(o) for o in zip(*single))
                  if key == "bwd" else torch.stack(single))
        err = _max_err(batched, plain())
        torch.cuda.synchronize()
        if (one_launch, single_launches) != (1, BATCH):
            raise AssertionError(f"binsplat {key}: a batch of {BATCH} took "
                                 f"{one_launch} launches, {BATCH} keyframes "
                                 f"{single_launches}")
        if not _equal(batched, single):
            raise AssertionError(f"binsplat {key}: the batched launch "
                                 f"differs from {BATCH} single launches")
        if not (_all_finite(batched) and err <= BIN_TOL[key]):
            raise AssertionError(f"binsplat {key}: batched kernel against "
                                 f"its batched plain twin: {err}")
        if key == "fwd":
            occ = (a5 != 0).reshape(-1).nonzero().squeeze(1)
            work = (4 * (slots + cells) + 32 * sum(_sectors(p, occ)
                                                   for p in p5),
                    OPS_PER_ELEMENT["binsplat_fwd"] * occupied)
        else:
            work = (4 * (8 * slots + cells),
                    OPS_PER_ELEMENT["binsplat_bwd"] * slots)
        t = {"ms": _median_ms(batched_call),
             "single_x4_ms": _median_ms(single_calls),
             "device_ms": _device_ms(batched_call),
             "single_x4_device_ms": _device_ms(single_calls),
             "launches": one_launch, "single_launches": single_launches,
             "max_abs_err": err}
        t["bound_ms"], t["bound_by"] = _bound(*work)
        emit({"phase": "bin_kernels_batched",
              "kernel": next(nm for k, nm, _ in BIN_KERNELS if k == key),
              "batch": BATCH, "K": K, "padded_grid": list(g5.shape[1:]),
              "occupied_slots": occupied, "tol": BIN_TOL[key],
              "bitwise_vs_single": True, **t, "card": card})
        out[key] = t
    return out


def _swirl_velocity(shape, t: int, cap: float = 1.5) -> np.ndarray:
    """Smooth swirl about the y axis plus a slow rise, |v| <= cap
    cells/frame, in array-axis channel order (vz, vy, vx)."""
    D, H, W = shape
    z, y, x = np.meshgrid(*[np.arange(n, dtype=np.float32) for n in shape],
                          indexing="ij")
    cz, cx = (D - 1) / 2.0, (W - 1) / 2.0
    dz, dx = z - cz, x - cx
    r = np.sqrt(dz ** 2 + dx ** 2) + 1e-6
    rmax = min(D, W) / 2.0
    speed = 1.2 * (r / rmax) * np.exp(1.0 - r / rmax) * (1.0 + 0.1 * t)
    v = np.stack([-dx / r * speed, 0.4 * np.ones_like(r), dz / r * speed],
                 axis=-1)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    v = v * np.minimum(1.0, cap / np.maximum(norm, 1e-6))
    return v.astype(np.float32)


def _plume_density(shape, t: int, rng) -> np.ndarray:
    D, H, W = shape
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32)
                            for n in shape], indexing="ij")
    blob = 2.0 * np.exp(-4.0 * (z ** 2 + (y + 0.3 - 0.05 * t) ** 2
                                + (x - 0.05 * t) ** 2))
    noise = 0.1 * rng.random(shape, dtype=np.float32)
    return (blob * (1.0 + noise)).astype(np.float32)


def _northstar_cfg(**over):
    from nfs_tpu_torch.core.config import StyleConfig, replace

    base = {
        "render.render_size": (256, 256),
        "render.n_views": 9,
        "render.view_pool": 32,
        "render.transmit": 0.01,
        "loss.style_layers": ("relu1_1", "relu2_1", "relu3_1", "relu4_1"),
        "loss.style_layer_weights": (1.0, 1.0, 1.0, 1.0),
        "loss.features_dtype": "bfloat16",
        "optim.octave_n": 3,
        "optim.octave_scale": 1.8,
        "optim.lr": 0.02,
        "optim.window": 1,
        "optim.log_every": 1,
    }
    base.update(over)
    return replace(StyleConfig(), **base)


def phase_reference(card: str):
    """The slice at a small size on the GPU against the same run on the
    CPU, where the port takes the plain twins and is held against the JAX
    package by tests/test_torch_styler.py. f32 features, W=1, both
    parameterizations, one view set per iteration (view_pool=1), 2 frames
    x 2 octaves x 2 iterations."""
    import torch

    from nfs_tpu_torch.styler.grid import GridStyler

    shape = (16, 12, 16)
    rng = np.random.default_rng(5)
    ds = np.stack([_plume_density(shape, t, rng) for t in range(2)])
    vs = (0.7 * rng.standard_normal((2,) + shape + (3,))).astype(np.float32)
    style = rng.random((32, 32, 3), dtype=np.float32)
    worst = {}
    for par in ("density", "velocity"):
        cfg = _northstar_cfg(**{
            "render.render_size": (32, 32), "render.min_render_size": 16,
            "render.n_views": 2, "render.view_pool": 1,
            "render.transmit": 0.5,
            "loss.style_layers": ("relu1_1", "relu2_1"),
            "loss.style_layer_weights": (1.0, 1.0),
            "loss.features_dtype": "float32", "optim.octave_n": 2,
            "optim.octave_scale": 2.0, "optim.iters": 2,
            "optim.parameterization": par})
        runs = {}
        for dev in ("cpu", "cuda"):
            styler = GridStyler(cfg, style_image=style, device=dev)
            losses = []
            outs = [d.cpu().numpy() for _, d, _ in styler.stylize_sequence(
                ds, vs, fused=0,
                callback=lambda done, loss, octave: losses.append(loss))]
            runs[dev] = (np.array(losses), np.stack(outs))
        (lc, dc), (lg, dg) = runs["cpu"], runs["cuda"]
        loss_rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
        d_err = float(np.abs(dg - dc).max())
        worst[par] = {"loss_rel": loss_rel, "d_star_max_abs": d_err}
        # f32 sums in other orders on the two devices, carried through 8
        # Adam steps (the CPU run matches JAX to ~4e-7 / 9e-5)
        if not (np.isfinite(dg).all() and loss_rel <= 1e-4
                and d_err <= 1e-3):
            raise AssertionError(f"{par}: GPU run departs from the CPU "
                                 f"reference: {worst[par]}")
    torch.cuda.synchronize()
    emit({"phase": "reference", "shape": list(shape), "vs": "cpu port",
          "tol": {"loss_rel": 1e-4, "d_star_max_abs": 1e-3},
          "err": worst, "card": card})


def phase_reference_particle(card: str):
    """The particle slice at a small size on the GPU (K4/K5) against the
    same run on the CPU (their plain versions; held against the JAX
    package by tests/test_torch_particle.py): position + density, a
    grid-space coarse octave and a window octave, 2 keyframes."""
    import torch

    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.ops import binsplat_kernels as bk
    from nfs_tpu_torch.styler.particle import ParticleStyler

    grid = (16, 12, 16)
    rng = np.random.default_rng(6)
    x0 = (rng.random((1500, 3)) * (np.array(grid) - 4) + 2).astype(
        np.float32)
    frames = [ParticleSet(x=x0 + 0.1 * t, dens=np.ones(1500, np.float32))
              for t in range(3)]
    style = rng.random((32, 32, 3), dtype=np.float32)
    cfg = _northstar_cfg(**{
        "render.render_size": (32, 32), "render.min_render_size": 16,
        "render.n_views": 2, "render.view_pool": 1, "render.transmit": 0.5,
        "loss.style_layers": ("relu1_1", "relu2_1"),
        "loss.style_layer_weights": (1.0, 1.0),
        "loss.features_dtype": "float32", "optim.octave_n": 2,
        "optim.octave_scale": 2.0, "optim.iters": 3, "optim.lr": 0.05,
        "particle.optimize_density": True, "particle.keyframe_stride": 2})
    runs = {}
    before = dict(bk.LAUNCHES)
    for dev in ("cpu", "cuda"):
        styler = ParticleStyler(cfg, grid_shape=grid, style_image=style,
                                device=dev)
        outs = [(p.x.cpu().numpy(), p.dens.cpu().numpy())
                for _, p in styler.stylize_keyframes(frames)]
        losses = torch.cat([torch.cat(i["octave_losses"]).cpu() for _, i in
                            sorted(styler.last_keyframe_infos.items())])
        runs[dev] = (losses.numpy(), outs)
    if bk.LAUNCHES["fwd"] == before["fwd"]:
        raise AssertionError("the GPU particle run did not launch K4")
    (lc, oc), (lg, og) = runs["cpu"], runs["cuda"]
    loss_rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    x_err = max(float(np.abs(g[0] - c[0]).max()) for g, c in zip(og, oc))
    d_err = max(float(np.abs(g[1] - c[1]).max()) for g, c in zip(og, oc))
    err = {"loss_rel": loss_rel, "x_max_abs": x_err, "dens_max_abs": d_err}
    # f32 sums in other orders carried through 12 Adam steps; Adam's
    # normalised step magnifies near-zero gradient components (the CPU
    # port matches JAX to <= 1e-6 in loss and <= 2e-4 in x)
    if not (loss_rel <= 1e-4 and x_err <= 1e-3 and d_err <= 1e-3):
        raise AssertionError(f"particle GPU run departs from the CPU "
                             f"reference: {err}")
    emit({"phase": "reference", "slice": "particle", "grid": list(grid),
          "vs": "cpu port", "tol": {"loss_rel": 1e-4, "x_max_abs": 1e-3,
                                    "dens_max_abs": 1e-3},
          "err": err, "card": card})


def phase_density(card: str, frames_dir: str):
    """Density parameterization, W=1, 3 frames through FrameStore.
    Returns the steady seconds per iteration (frames 1-2)."""
    import torch

    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.styler.grid import GridStyler

    T, iters = 3, 5
    rng = np.random.default_rng(0)
    store = FrameStore(frames_dir)
    for t in range(T):
        store.save_density(t, _plume_density(SHAPE, t, rng))
        store.save_velocity(t, _swirl_velocity(SHAPE, t))
    ds = np.stack([store.load_density(t) for t in range(T)])
    vs = np.stack([store.load_velocity(t) for t in range(T)])

    cfg = _northstar_cfg(**{"optim.iters": iters})
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    styler = GridStyler(cfg, style_image=style, device="cuda")

    losses = {}  # (frame, octave) -> per-iteration losses

    def on_chunk(done, loss, octave, frame):
        losses.setdefault((frame, octave), []).append(loss)

    frame_s = []
    outs = []
    ak.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frame = {"t": 0}

    def cb(done, loss, octave):
        on_chunk(done, loss, octave, frame["t"])

    for t, d_star, _ in styler.stylize_sequence(ds, vs, callback=cb,
                                                fused=0):
        out = d_star.cpu().numpy()  # synchronises
        frame_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        outs.append(out)
        frame["t"] = t + 1
    launches = dict(ak.LAUNCHES)

    for t, out in enumerate(outs):
        if out.shape != SHAPE or not np.isfinite(out).all():
            raise AssertionError(f"frame {t}: bad output {out.shape}")
        if out.min() < 0.0:
            raise AssertionError(f"frame {t}: negative density")
        if np.abs(out - ds[t]).max() == 0.0:
            raise AssertionError(f"frame {t}: output equals its input")
    finest = losses[(0, cfg.optim.octave_n - 1)]
    if not finest[-1] < finest[0]:
        raise AssertionError(f"finest octave loss did not drop: {finest}")
    if launches["fwd"] <= 0 or launches["bwd_field"] <= 0:
        raise AssertionError(f"kernels not launched: {launches}")
    iters_per_frame = iters * cfg.optim.octave_n
    steady = sum(frame_s[1:]) / ((T - 1) * iters_per_frame)
    emit({"phase": "density", "frames": T, "shape": list(SHAPE),
          "reduced": f"optim.iters {iters} per octave (config #3: 20) to "
                     f"fit the time limit; random VGG weights and style",
          "frame_s": frame_s, "steady_s_per_iter": steady,
          "s_per_frame_steady": sum(frame_s[1:]) / (T - 1),
          "finest_octave_losses_frame0": finest,
          "launches": launches, "card": card,
          "note": "callback reads each iteration's loss (log_every=1)"})
    return steady


def phase_velocity(card: str, fused_bwd: bool = False, split=None):
    """Velocity parameterization (config #4), one frame, W=1. Returns its
    per-iteration losses and launches (read from this run alone). With
    ``fused_bwd`` it runs under ``FUSED_BWD``: every advection of this
    path needs one gradient (the density through the optimized velocity,
    the window loss through the sim's), so the backward still runs K2 or
    K3 alone, never K3b; the launches must equal those of the split run
    ``split`` = (losses, launches), and its losses too."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.styler.grid import GridStyler

    cfg = _northstar_cfg(**{"optim.parameterization": "velocity",
                            "optim.octave_n": 2, "optim.iters": 3,
                            "optim.log_every": 3})
    style = np.random.default_rng(2).random((256, 256, 3),
                                            dtype=np.float32)
    styler = GridStyler(cfg, style_image=style, device="cuda")
    rng = np.random.default_rng(3)
    ds = _plume_density(SHAPE, 0, rng)[None]
    vs = _swirl_velocity(SHAPE, 0)[None]
    before = dict(ak.LAUNCHES)
    ak.FUSED_BWD = fused_bwd
    try:
        t0 = time.perf_counter()
        outs = [(d.cpu().numpy(), p.cpu().numpy())
                for _, d, p in styler.stylize_sequence(ds, vs, fused=0)]
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        ak.FUSED_BWD = False
    launches = {k: ak.LAUNCHES[k] - before[k] for k in before}
    losses = styler.frame_losses[0].cpu().numpy()
    d_star, param = outs[0]
    if d_star.shape != SHAPE or param.shape != SHAPE + (3,):
        raise AssertionError(f"bad shapes {d_star.shape} {param.shape}")
    if not (np.isfinite(d_star).all() and np.isfinite(param).all()):
        raise AssertionError("non-finite velocity-slice output")
    if np.abs(param).max() == 0.0:
        raise AssertionError("velocity parameter never moved")
    record = {"phase": "velocity", "shape": list(SHAPE), "octave_n": 2,
              "iters": 3, "fused_bwd": fused_bwd,
              "seconds_incl_warmup": seconds,
              "max_abs_param": float(np.abs(param).max()),
              "launches": launches, "card": card}
    if not fused_bwd:
        if launches["bwd_vel"] <= 0:
            raise AssertionError(f"K3 not launched: {launches}")
        emit(record)
        return losses, launches
    split_losses, split_launches = split
    if launches != split_launches or launches["bwd_fused"] != 0:
        raise AssertionError(f"FUSED_BWD run launched {launches}, the "
                             f"split run {split_launches}")
    # the same kernels on the same inputs; what may remain is the order
    # in which the device sums the loss
    loss_rel = float(np.max(np.abs(losses - split_losses)
                            / np.abs(split_losses)))
    if not loss_rel <= 1e-5:
        raise AssertionError(f"FUSED_BWD losses depart from the split "
                             f"run's: {loss_rel}")
    emit(dict(record, loss_rel_vs_split=loss_rel, tol=1e-5))
    return losses, launches


def phase_fused_bwd_ab(card: str):
    """The full two-gradient chain of bench/advect_bench.py:71-82 at
    112x64x112, max_disp 2: 50 chained descent steps on sum(advect(f,
    v)^2), gradients in both f and v, with FUSED_BWD off (K2 + K3) and on
    (K3b), in turns off, on, on, off; ms per step is the median of each
    setting's two runs. The path of K3b: returns its launches in the two
    runs with FUSED_BWD on (warm-ups included), read from this phase
    alone."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops.advect import advect

    steps = 50
    rng = np.random.default_rng(0)
    f0 = torch.from_numpy(rng.random(SHAPE, dtype=np.float32)).cuda()
    v0 = torch.from_numpy((0.8 * rng.standard_normal(SHAPE + (3,))).astype(
        np.float32)).cuda()

    def chain(n):
        f, v = f0, v0
        for _ in range(n):
            f = f.detach().requires_grad_(True)
            v = v.detach().requires_grad_(True)
            gf, gv = torch.autograd.grad(
                (advect(f, v, max_disp=2.0) ** 2).sum(), (f, v))
            f, v = f - 1e-4 * gf, v - 1e-4 * gv
        return f.detach(), v.detach()

    ms = {False: [], True: []}
    ends = {}
    launches = {False: dict.fromkeys(ak.LAUNCHES, 0),
                True: dict.fromkeys(ak.LAUNCHES, 0)}
    try:
        for fused in (False, True, True, False):
            ak.FUSED_BWD = fused
            ak.reset_launches()
            chain(3)   # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ends[fused] = chain(steps)
            torch.cuda.synchronize()
            ms[fused].append((time.perf_counter() - t0) * 1e3 / steps)
            for k, n in ak.LAUNCHES.items():
                launches[fused][k] += n
    finally:
        ak.FUSED_BWD = False
    if not (launches[True]["bwd_fused"] > 0
            and launches[True]["bwd_field"] == launches[True]["bwd_vel"] == 0
            and launches[False]["bwd_fused"] == 0
            and launches[False]["bwd_field"] > 0
            and launches[False]["bwd_vel"] > 0):
        raise AssertionError(f"fused/split runs launched {launches}")
    err = _max_err(ends[True], ends[False])
    if not err <= 1e-4:
        raise AssertionError(f"fused and split chains end apart: {err}")
    emit({"phase": "fused_bwd_ab", "shape": list(SHAPE), "max_disp": 2.0,
          "steps": steps, "ms_per_step_split": ms[False],
          "ms_per_step_fused": ms[True],
          "fused_over_split": statistics.median(ms[True])
          / statistics.median(ms[False]),
          "end_state_max_abs_diff": err,
          "launches": {"split": launches[False], "fused": launches[True]},
          "card": card})
    return launches[True]["bwd_fused"]


def phase_far(card: str):
    """The density slice's first frame at config #3 widths (W=1, 3
    octaves x 2 iterations) with ``optim.max_disp`` 9: the window loss's
    backward takes K2's untiled pull (R = 9). Then the same frame at
    max_disp 2 (the tiled pull): the swirl's |v| <= 1.5 never reaches
    either clamp, so both runs sum the same nonzero terms, and they are
    held to the GPU-vs-CPU tolerances (the rest of the loss is not
    bitwise repeatable). Returns the untiled pull's launches in the
    max_disp 9 run, read from that run alone."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.styler.grid import GridStyler

    rng = np.random.default_rng(4)
    ds = _plume_density(SHAPE, 0, rng)[None]
    vs = _swirl_velocity(SHAPE, 0)[None]
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    runs = {}
    for md in (9.0, 2.0):
        cfg = _northstar_cfg(**{"optim.iters": 2, "optim.max_disp": md})
        styler = GridStyler(cfg, style_image=style, device="cuda")
        ak.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [d.cpu().numpy() for _, d, _ in
                styler.stylize_sequence(ds, vs, fused=0)]
        seconds = time.perf_counter() - t0
        runs[md] = (styler.frame_losses[0].cpu().numpy(), outs[0],
                    dict(ak.LAUNCHES), seconds)
    (l9, d9, n9, s9), (l2, d2, n2, s2) = runs[9.0], runs[2.0]
    if not (n9["bwd_field_untiled"] > 0 and n9["bwd_field"] == 0
            and n2["bwd_field"] > 0 and n2["bwd_field_untiled"] == 0):
        raise AssertionError(f"max_disp 9 launched {n9}, 2 {n2}")
    err = {"loss_rel": float(np.max(np.abs(l9 - l2) / np.abs(l2))),
           "d_star_max_abs": float(np.abs(d9 - d2).max())}
    if not (d9.shape == SHAPE and np.isfinite(d9).all()
            and err["loss_rel"] <= 1e-4 and err["d_star_max_abs"] <= 1e-3):
        raise AssertionError(f"max_disp 9 departs from max_disp 2: {err}")
    emit({"phase": "far", "shape": list(SHAPE), "max_disp": 9.0,
          "octave_n": 3, "iters": 2, "launches": n9,
          "vs_max_disp_2": err, "tol": {"loss_rel": 1e-4,
                                        "d_star_max_abs": 1e-3},
          "seconds_incl_warmup": {"max_disp_9": s9, "max_disp_2": s2},
          "card": card})
    return n9["bwd_field_untiled"]


def _all_frames_finite(store, frames: int, particles: bool) -> bool:
    for t in range(frames):
        arrays = ([store.load_particles(t)["x"]] if particles else
                  [store.load_density(t), store.load_velocity(t)])
        if not all(np.isfinite(a).all() for a in arrays):
            return False
    return True


def _liquid_particles(res) -> int:
    """Particles cli.scene's liquid3d seeds: 4 per cell of the block
    [0.05, 0.5) x [0.3, 0.7)^2 (29 x 25 x 25 x 4 = 72 500 at 64^3)."""
    return 4 * math.prod(int(h * n) - int(l * n) for l, h, n in
                         zip((0.05, 0.3, 0.3), (0.5, 0.7, 0.7), res))


def phase_scene(card: str, root: str):
    """``cli.scene`` twice: smoke3d at 112x64x112 for 16 frames (K1
    exactly 7 per solver step) and liquid3d at 64^3 for 8 frames."""
    import torch

    from nfs_tpu_torch.cli import scene
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import advect_kernels as ak

    out = {}
    for name, res, frames in (("smoke3d", SHAPE, 16),
                              ("liquid3d", LIQUID_GRID, 8)):
        path = os.path.join(root, name)
        ak.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scene.main(["--scene", name, "--out", path, "--res",
                    *map(str, res), "--frames", str(frames)])
        wall = time.perf_counter() - t0
        launches = dict(ak.LAUNCHES)
        store = FrameStore(path)
        if not _all_frames_finite(store, frames, name == "liquid3d"):
            raise AssertionError(f"{name}: non-finite frames")
        rec = {"res": list(res), "frames": frames, "wall_s": wall,
               "s_per_frame_incl_writes": wall / frames}
        if name == "smoke3d":
            if launches["fwd"] != 7 * frames:
                raise AssertionError(f"smoke3d: K1 launched "
                                     f"{launches['fwd']}, not 7 per step")
            rec["k1_launches"] = launches["fwd"]
        else:
            rec["particles"] = int(store.load_particles(0)["x"].shape[0])
            if rec["particles"] != _liquid_particles(res):
                raise AssertionError(f"liquid3d: {rec['particles']} "
                                     f"particles")
        out[name] = rec
    emit({"phase": "scene", **out,
          "note": "wall includes writing each frame with "
                  "np.savez_compressed", "card": card})
    return os.path.join(root, "smoke3d")


def phase_northstar(card: str, root: str):
    """bench/northstar.py:79-142 at 16 frames: smoke_sequence_cached into a
    chunk directory (warm-up 10, chunk 8), then iter_sequence_blocks
    (halo 1) into stylize_sequence_blocks(fused=4) at the density slice's
    config #3 widths, frames 0-7 held against the streaming path on the
    same frames. Returns the launches of the sim and of the blocks."""
    import torch

    from nfs_tpu_torch.io.stream import (iter_sequence_blocks,
                                         load_sequence_cache)
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.sim.smoke import SmokeConfig, smoke_sequence_cached
    from nfs_tpu_torch.styler.grid import GridStyler

    frames, iters, fused = 16, 5, 4
    cache = os.path.join(root, "northstar_16")
    ak.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = smoke_sequence_cached(
        SmokeConfig(shape=SHAPE, source_center=(0.5, 0.85, 0.5),
                    jacobi_iters=20, max_disp=2.0),
        frames, cache, warmup=10, chunk=8)
    sim_s = time.perf_counter() - t0
    sim_launches = dict(ak.LAUNCHES)
    # warm-up 10 rounds up to 2 chunks of 8: 32 solver steps x 7 K1
    if not done or sim_launches["fwd"] != 7 * 32:
        raise AssertionError(f"sim: done={done} launches={sim_launches}")

    cfg = _northstar_cfg(**{"optim.iters": iters})
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    styler = GridStyler(cfg, style_image=style, device="cuda")
    ak.reset_launches()
    torch.cuda.synchronize()
    marks, blocks = [time.perf_counter()], {}
    for t, d_star, _ in styler.stylize_sequence_blocks(
            iter_sequence_blocks(cache, halo=cfg.optim.window),
            fused=fused):
        blocks[t] = d_star.cpu().numpy()   # synchronises
        marks.append(time.perf_counter())
    block_launches = dict(ak.LAUNCHES)
    block_losses = {t: l.cpu().numpy() for t, l in
                    styler.frame_losses.items()}
    if sorted(blocks) != list(range(frames)):
        raise AssertionError(f"blocks yielded frames {sorted(blocks)}")
    for t, d in blocks.items():
        if d.shape != SHAPE or not np.isfinite(d).all() or d.min() < 0:
            raise AssertionError(f"block frame {t}: bad output")
    if block_launches["fwd"] <= 0 or block_launches["bwd_field"] <= 0:
        raise AssertionError(f"blocks launched {block_launches}")
    frame_s = np.diff(marks)
    chunk_s = frame_s.reshape(-1, fused).sum(axis=1)

    # the same frames through the streaming path, timed alike
    ds, vs = load_sequence_cache(cache)
    held = 8
    worst = {"loss_rel": 0.0, "d_star_max_abs": 0.0}
    stream_marks = [time.perf_counter()]
    for t, d_star, _ in styler.stylize_sequence(ds[:held], vs[:held],
                                                fused=0):
        d_star = d_star.cpu().numpy()   # synchronises
        stream_marks.append(time.perf_counter())
        ref = styler.frame_losses[t].cpu().numpy()
        worst["loss_rel"] = max(worst["loss_rel"], float(np.max(
            np.abs(block_losses[t] - ref) / np.abs(ref))))
        worst["d_star_max_abs"] = max(worst["d_star_max_abs"], float(
            np.abs(blocks[t] - d_star).max()))
    if not (worst["loss_rel"] <= 1e-4 and worst["d_star_max_abs"] <= 1e-3):
        raise AssertionError(f"blocks depart from streaming: {worst}")
    emit({"phase": "northstar", "frames": frames, "shape": list(SHAPE),
          "fused": fused, "window": cfg.optim.window,
          "reduced": f"16 frames (north star: 200); optim.iters {iters} "
                     f"per octave (config #3: 20); random VGG weights and "
                     f"style",
          "sim_s": sim_s, "sim_s_per_frame": sim_s / frames,
          "sim_steps": 32, "sim_launches": sim_launches,
          "block_chunk_s": chunk_s.tolist(),
          "s_per_frame_steady": float(chunk_s[1:].sum())
          / ((len(chunk_s) - 1) * fused),
          "frames_1_7_s_per_frame": {
              "blocks": float(frame_s[1:held].mean()),
              "streaming": float(np.diff(stream_marks)[1:].mean())},
          "block_launches": block_launches,
          "vs_streaming_frames_0_7": worst,
          "tol": {"loss_rel": 1e-4, "d_star_max_abs": 1e-3}, "card": card})


def phase_cli(card: str, root: str, data_dir: str):
    """``cli.stylize --fused 2`` over 4 scene frames (2 octaves x 2
    iterations, W=1), then once more: the manifest is complete, so the
    rerun stylizes nothing; then ``cli.stylize --parallel --mode
    particle`` over 3 frames of the particles_3d scene (keyframes 0 and
    2 through the keyframe-parallel engine, 2 octaves x 2 iterations),
    which must launch K4 and K5."""
    from nfs_tpu_torch.cli.stylize import main as stylize
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import binsplat_kernels as bk

    style = os.path.join(root, "style.npy")
    np.save(style, np.random.default_rng(1).random((256, 256, 3),
                                                   dtype=np.float32))
    log = os.path.join(root, "log")
    argv = ["--data_dir", data_dir, "--log_dir", log, "--tag", "cli",
            "--style_target", style, "--num_frames", "4", "--window", "1",
            "--fused", "2", "--octave_n", "2", "--iter", "2"]
    runs = []
    for _ in range(2):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            stylize(argv)
        runs.append((time.perf_counter() - t0, buf.getvalue()))
    out_dir = os.path.join(log, "cli")
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    params = sorted(p for p in os.listdir(out_dir) if p.startswith("param"))
    store = FrameStore(out_dir)
    if not (sorted(manifest) == ["0", "1", "2", "3"]
            and params == ["param_0001.npz", "param_0003.npz"]
            and all(np.isfinite(store.load_density(t)).all()
                    for t in range(4))):
        raise AssertionError(f"cli: manifest {sorted(manifest)}, params "
                             f"{params}")
    if ("all frames already stylized" not in runs[1][1]
            or "[frame" in runs[1][1]):
        raise AssertionError(f"the rerun stylized again: {runs[1][1]}")

    pdata = os.path.join(root, "cli_particles")
    pstore = FrameStore(pdata)
    for t, x in enumerate(_particle_frames(3)):
        pstore.save_particles(t, x=x, dens=np.ones(P_COUNT, np.float32))
    buf = io.StringIO()
    bk.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        stylize(["--data_dir", pdata, "--log_dir", log, "--tag", "lnst",
                 "--style_target", style, "--mode", "particle", "--parallel",
                 "--num_frames", "3", "--keyframe_stride", "2",
                 "--opt_density", "--grid_shape", *map(str, P_GRID),
                 "--octave_n", "2", "--iter", "2"])
    particle_s = time.perf_counter() - t0
    p_launches = dict(bk.LAUNCHES)
    pout = FrameStore(os.path.join(log, "lnst"))
    if not (all(np.isfinite(pout.load_particles(t)["x"]).all()
                for t in range(3))
            and "[parallel] 3 particle frames, keyframes [0, 2]"
            in buf.getvalue()
            and p_launches["fwd"] > 0 and p_launches["bwd"] > 0):
        raise AssertionError(f"cli --parallel --mode particle: "
                             f"{buf.getvalue()} {p_launches}")
    emit({"phase": "cli", "frames": 4, "fused": 2, "wall_s": runs[0][0],
          "rerun_s": runs[1][0], "params_saved": params,
          "parallel_particle": {"frames": 3, "keyframes": [0, 2],
                                "wall_s": particle_s,
                                "launches": p_launches},
          "card": card})


def _particle_frames(T: int):
    """The lnst_vs_tnst_seq bench scene (bench/full_bench.py:263-279): the
    particles_3d particles advected by a swirl about the grid's centre,
    float32 as the bench computes it."""
    x = _bench_particles(np.random.default_rng(0))
    c = np.array([48.0, 32.0, 48.0], np.float32)
    xs = [x]
    for _ in range(T - 1):
        r = xs[-1] - c
        swirl = np.stack([-r[:, 2], np.full_like(r[:, 0], 0.3), r[:, 0]],
                         axis=-1)
        xs.append((xs[-1] + np.float32(0.02) * swirl).astype(np.float32))
    return xs


def _particle_cfg(**over):
    """The particles_3d bench config (bench/full_bench.py:208-215) at 20
    iterations per octave, keyframe stride 10."""
    from nfs_tpu_torch.core.config import StyleConfig, replace

    base = {"render.render_size": (256, 256), "render.n_views": 9,
            "render.transmit": 0.05, "loss.features_dtype": "bfloat16",
            "optim.octave_n": 3, "optim.iters": 20,
            "particle.optimize_position": True,
            "particle.optimize_density": True,
            "particle.keyframe_stride": 10}
    base.update(over)
    return replace(StyleConfig(), **base)


def _octave_ks():
    """((grid, K) of each octave): the bin capacities the styler plans
    for the particle phase's first keyframe (its own `_octave_ks`, margin
    2), coarsest first."""
    import torch

    from nfs_tpu_torch.ops.resize import octave_shapes
    from nfs_tpu_torch.styler.particle import ParticleStyler

    cfg = _particle_cfg()
    styler = ParticleStyler(cfg, grid_shape=P_GRID, device="cuda")
    x = torch.from_numpy(_particle_frames(1)[0]).cuda()
    shapes = octave_shapes(P_GRID, cfg.optim.octave_n, cfg.optim.octave_scale)
    return list(zip(shapes, styler._octave_ks(x, None, shapes, margin=2)))


def phase_particle(card: str, profile: bool):
    """LNST keyframes at full width: 11 frames of 200 000 particles,
    keyframes 0 and 10. Returns the K4/K5 launches of the run."""
    import torch

    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.ops import binsplat_kernels as bk
    from nfs_tpu_torch.styler.particle import ParticleStyler

    T = 11
    cfg = _particle_cfg()
    oc, pc = cfg.optim, cfg.particle
    xs = _particle_frames(T)
    dens = np.ones(P_COUNT, np.float32)
    psets = [ParticleSet(x=x, dens=dens) for x in xs]
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    styler = ParticleStyler(cfg, grid_shape=P_GRID, style_image=style,
                            device="cuda")

    # host clock at every loss readback (log_every iterations in the
    # grid-space octaves, once per rebin chunk in the finest)
    marks = []
    kf_s, kf_init = [], []
    stylize_frame = styler.stylize_frame

    def timed_frame(*args, **kw):
        kf_init.append(kw.get("init_param"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = stylize_frame(*args, **kw)   # ends in a host sync
        kf_s.append(time.perf_counter() - t0)
        return out

    styler.stylize_frame = timed_frame
    bk.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for t, p in styler.stylize_keyframes(
            psets, callback=lambda done, loss, octave: marks.append(
                (octave, done, time.perf_counter()))):
        outs.append((t, p.x.cpu().numpy(), p.dens.cpu().numpy()))
    wall = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    del styler.stylize_frame

    if [t for t, _, _ in outs] != list(range(T)):
        raise AssertionError(f"frames out of order: {[o[0] for o in outs]}")
    worst_dx = 0.0
    for t, x, d in outs:
        if not (np.isfinite(x).all() and np.isfinite(d).all()
                and x.shape == (P_COUNT, 3) and d.shape == (P_COUNT,)):
            raise AssertionError(f"frame {t}: bad output")
        worst_dx = max(worst_dx, float(np.abs(x - xs[t]).max()))
    if worst_dx > pc.max_offset:
        raise AssertionError(f"|dx| {worst_dx} > max_offset")
    infos = styler.last_keyframe_infos
    finest = infos[0]["octave_losses"][-1].cpu().numpy()
    if not finest[-1] < finest[0]:
        raise AssertionError(f"finest octave loss did not drop: {finest}")
    if launches["fwd"] <= 0 or launches["bwd"] <= 0:
        raise AssertionError(f"K4/K5 not launched: {launches}")
    # finest octave of keyframe 10: from the last readback of octave 1 to
    # the readback that ends octave 2 (the whole 20-iteration chunk)
    kf10 = marks[len(marks) // 2:]
    t_in = max(m[2] for m in kf10 if m[0] == oc.octave_n - 2)
    t_out = max(m[2] for m in kf10 if m[0] == oc.octave_n - 1)
    emit({"phase": "particle", "frames": T, "keyframes": sorted(infos),
          "particles": P_COUNT, "grid": list(P_GRID),
          "k_plan": next(iter(styler._k_cache.values())),
          "reduced": "nothing of the particles_3d bench widths: random VGG "
                     "weights and style image (no downloads)",
          "keyframe_s": kf_s,
          "finest_s_per_iter_kf10": (t_out - t_in) / oc.iters,
          "s_per_output_frame": wall / T, "wall_s": wall,
          "finest_octave_losses_kf0": finest.tolist(),
          "octave_overflow": {kf: i["octave_overflow"]
                              for kf, i in infos.items()},
          "max_abs_dx": worst_dx, "launches": launches,
          "launches_predicted": {"fwd": 44, "bwd": 40}, "card": card})
    if profile:
        _profile_particle(card, styler, psets[10], kf_init[1])
    return launches


_CATEGORIES = (
    # (category, substrings of the kernel name), first match wins
    ("advect kernels K1-K3", ("advect_",)),
    ("binsplat kernels K4-K5", ("binsplat_",)),
    ("VGG convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv",
                                  "Conv")),
    ("f32 GEMM (shear bmm, Gram)", ("gemm", "Gemm")),
    ("VGG pooling", ("pool",)),
    ("elementwise/reduce/copy", ("elementwise", "reduce", "copy", "Copy",
                                 "Functor", "Memset", "Memcpy")),
)


def phase_profile(card: str):
    """Density slice (W=1) at config #3's 20 iterations per octave, no
    loss readback. Four untraced frames give the steady seconds per
    iteration and per frame (frames 1-3). Two more frames run under
    torch.profiler: the device time of every kernel, summed by category,
    and the device's idle share in that traced run (1 - kernel time /
    host wall time of the same run; the profiler slows the host, so
    this bounds the untraced idle share from above)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nfs_tpu_torch.styler.grid import GridStyler

    T, iters, traced = 4, 20, 2
    rng = np.random.default_rng(0)
    ds = np.stack([_plume_density(SHAPE, t, rng) for t in range(T)])
    vs = np.stack([_swirl_velocity(SHAPE, t) for t in range(T)])
    cfg = _northstar_cfg(**{"optim.iters": iters})
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    styler = GridStyler(cfg, style_image=style, device="cuda")
    iters_per_frame = iters * cfg.optim.octave_n

    frame_s = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, d_star, _ in styler.stylize_sequence(ds, vs, fused=0):
        d_star.cpu()  # synchronises
        frame_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
    steady = sum(frame_s[1:]) / ((T - 1) * iters_per_frame)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _, d_star, _ in styler.stylize_sequence(ds[:traced],
                                                    vs[:traced], fused=0):
            d_star.cpu()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    n_iter = traced * iters_per_frame
    emit(dict({"phase": "profile", "slice": "density",
               "shape": list(SHAPE), "window": 1,
               "iters_per_octave": iters, "frame_s": frame_s,
               "steady_s_per_iter": steady,
               "s_per_frame_steady": sum(frame_s[1:]) / (T - 1)},
              **_trace_summary(prof, n_iter, traced_wall), card=card))


def _trace_summary(prof, n_iter: int, traced_wall: float) -> dict:
    """Device time of every kernel in a torch.profiler run, summed by
    category per iteration, and the device's idle share in that run
    (1 - kernel time / host wall time; the profiler slows the host, so
    this bounds the untraced idle share from above)."""
    import torch

    by_cat, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.self_device_time_total
        cat = next((c for c, keys in _CATEGORIES
                    if any(k in e.key for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        kernels.append((us, e.count, e.key[:90]))
    busy_s = sum(by_cat.values()) / 1e6
    if busy_s <= 0.0:
        raise AssertionError("the profiler saw no device time")
    kernels.sort(reverse=True)
    return {"traced_iters": n_iter, "traced_wall_s": traced_wall,
            "traced_s_per_iter": traced_wall / n_iter,
            "kernel_ms_per_iter": busy_s * 1e3 / n_iter,
            "idle_share_traced": 1.0 - busy_s / traced_wall,
            "kernel_ms_per_iter_by_category": {
                c: us / 1e3 / n_iter
                for c, us in sorted(by_cat.items(), key=lambda x: -x[1])},
            "top_kernels_ms_per_iter": [
                [us / 1e3 / n_iter, count, name]
                for us, count, name in kernels[:12]]}


def _profile_particle(card: str, styler, pset, init_param):
    """Keyframe 10 of the particle phase once more, warm-started from
    keyframe 0 as in the sequence, under torch.profiler: kernel time per
    iteration (all three octaves) by category and the idle share of the
    traced run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    oc = styler.cfg.optim
    init = init_param
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        styler.stylize_frame(pset, init_param=init)
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    n_iter = oc.octave_n * oc.iters
    emit(dict({"phase": "profile", "slice": "particle", "keyframe": 10,
               "grid": list(P_GRID), "particles": P_COUNT},
              **_trace_summary(prof, n_iter, traced_wall), card=card))


# BASELINE config #1 and #2's 2D grid and the BASELINE metric's 2D 512^2
# headline shape (bench/full_bench.py:56-111); config #5's 2D particle
# grid (bench/full_bench.py:162-190)
TWO_D = (256, 192)
TWO_D_HEADLINE = (512, 512)
LIQUID2D_GRID = (128, 128)


def _blob2d(shape) -> np.ndarray:
    """bench/full_bench.py's _blob: a Gaussian of peak 2."""
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    return (2.0 * np.exp(-4 * sum(x ** 2 for x in g))).astype(np.float32)


def _check_grid_out(name, out, d_in):
    if not (out.shape == d_in.shape and np.isfinite(out).all()
            and out.min() >= 0.0 and np.abs(out - d_in).max() > 0.0):
        raise AssertionError(f"{name}: bad output {out.shape}")


def _octave_s_per_iter(marks, octave: int, iters: int) -> float:
    """Seconds per iteration of an octave (> 0) from the host clock at the
    loss readbacks (octave, done, time): from the last readback of the
    octave before to the last of this one, which ends it."""
    t_in = max(t for o, _, t in marks if o == octave - 1)
    t_out = max(t for o, _, t in marks if o == octave)
    return (t_out - t_in) / iters


def _reference_2d(card: str):
    """A 2D frame and a 2D W=1 sequence at a small size on the GPU
    against the same runs on the CPU (held against the JAX package by
    tests/test_torch_grid2d.py, whose style weight 1000 this takes: the
    gradients stand above Adam's eps, where f32 rounding is not turned
    into whole steps)."""
    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.styler.grid import GridStyler

    shape = (24, 18)
    rng = np.random.default_rng(7)
    ds = np.stack([_blob2d(shape) * (1 + 0.2 * rng.random(shape))
                   for _ in range(2)]).astype(np.float32)
    vs = (0.7 * rng.standard_normal((2,) + shape + (2,))).astype(np.float32)
    style = rng.random((32, 32, 3), dtype=np.float32)
    cfg = replace(StyleConfig(), **{
        "render.render_size": (32, 32), "render.min_render_size": 16,
        "loss.style_layers": ("relu1_1", "relu2_1"),
        "loss.style_layer_weights": (1.0, 1.0), "loss.w_style": 1000.0,
        "loss.w_tv": 0.1, "optim.octave_n": 2, "optim.octave_scale": 2.0,
        "optim.iters": 3, "optim.lr": 0.02, "optim.window": 1,
        "optim.log_every": 1})
    runs = {}
    for dev in ("cpu", "cuda"):
        styler = GridStyler(cfg, style_image=style, device=dev)
        losses = []
        cb = lambda done, loss, octave: losses.append(loss)  # noqa: E731
        d0, _, _ = styler.stylize_frame(ds[0], callback=cb)
        outs = [d0.cpu().numpy()] + [
            d.cpu().numpy() for _, d, _ in styler.stylize_sequence(
                ds, vs, fused=0, callback=cb)]
        runs[dev] = (np.array(losses), np.stack(outs))
    (lc, dc), (lg, dg) = runs["cpu"], runs["cuda"]
    err = {"loss_rel": float(np.max(np.abs(lg - lc) / np.abs(lc))),
           "d_star_max_abs": float(np.abs(dg - dc).max())}
    if not (np.isfinite(dg).all() and err["loss_rel"] <= 1e-4
            and err["d_star_max_abs"] <= 1e-3):
        raise AssertionError(f"2D GPU run departs from the CPU: {err}")
    return {"shape": list(shape), "vs": "cpu port", "err": err,
            "tol": {"loss_rel": 1e-4, "d_star_max_abs": 1e-3}}


def phase_2d(card: str):
    """BASELINE config #1 (a 256x192 frame, bf16 features, 3 octaves x 30
    iterations), the 512^2 headline shape (3 x 10 iterations) and config
    #2 (a 256x192 smoke_sequence, W=1, 2 octaves x 20 iterations, 6
    frames), each through GridStyler on the card; a frame runs twice and
    the second run is timed. The 2D path advects by the window-tap sum
    and renders the grid itself: it launches none of the hand kernels
    (the launches are read from this phase alone to show it). Then the
    small 2D GPU-against-CPU comparison."""
    import torch

    from nfs_tpu_torch.core.config import StyleConfig, replace
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops import binsplat_kernels as bk
    from nfs_tpu_torch.sim.smoke import SmokeConfig, smoke_sequence
    from nfs_tpu_torch.styler.grid import GridStyler

    rng = np.random.default_rng(11)
    ak.reset_launches()
    bk.reset_launches()
    record = {"phase": "2d", "card": card}
    for name, shape, iters in (("config1", TWO_D, 30),
                               ("config1b_512", TWO_D_HEADLINE, 10)):
        cfg = replace(StyleConfig(), **{
            "render.render_size": shape, "loss.features_dtype": "bfloat16",
            "optim.octave_n": 3, "optim.iters": iters})
        styler = GridStyler(cfg, style_image=rng.random(
            shape + (3,), dtype=np.float32), device="cuda")
        d = _blob2d(shape)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d_star, _, info = styler.stylize_frame(d)
            out = d_star.cpu().numpy()
            walls.append(time.perf_counter() - t0)
        _check_grid_out(name, out, d)
        finest = info["octave_losses"][-1].cpu().numpy()
        if not finest[-1] < finest[0]:
            raise AssertionError(f"{name}: finest loss did not drop")
        record[name] = {"grid": list(shape), "iters": 3 * iters,
                        "s_per_frame": walls[1],
                        "s_per_iter": walls[1] / (3 * iters),
                        "first_run_s": walls[0]}
    record["config1b_512"]["reduced"] = "10 iterations per octave (30)"

    T, iters = 6, 20
    t0 = time.perf_counter()
    ds, vs = smoke_sequence(SmokeConfig(shape=TWO_D, jacobi_iters=20), T,
                            device="cuda")
    sim_s = time.perf_counter() - t0
    cfg = replace(StyleConfig(), **{
        "render.render_size": TWO_D, "loss.features_dtype": "bfloat16",
        "optim.octave_n": 2, "optim.iters": iters, "optim.window": 1})
    styler = GridStyler(cfg, style_image=rng.random(
        TWO_D + (3,), dtype=np.float32), device="cuda")
    frame_s = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, d_star, param in styler.stylize_sequence(ds, vs, fused=0):
        out = d_star.cpu().numpy()
        frame_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _check_grid_out(f"config2 frame {t}", out, ds[t])
    steady = statistics.median(frame_s[1:])
    record["config2"] = {
        "grid": list(TWO_D), "frames": T, "window": 1,
        "iters_per_frame": 2 * iters, "frame_s": frame_s,
        "s_per_frame_steady": steady, "s_per_iter": steady / (2 * iters),
        "sim_s": sim_s, "reduced": f"{T} frames (BASELINE: 120, "
                                   "bench/full_bench.py: 24)"}
    launches = {**dict(ak.LAUNCHES), **{"splat_" + k: n
                                         for k, n in bk.LAUNCHES.items()}}
    if any(launches.values()):
        raise AssertionError(f"the 2D path launched {launches}")
    record["launches"] = launches
    record["reference"] = _reference_2d(card)
    emit(record)


def _color_pass_ms(x, dens, color, K: int):
    """Times, at the finest octave of the colour keyframe (its grid and
    bin capacity K), of the one 5-channel binned pass [density,
    colour(3), ones] that the colour path runs every iteration, forward
    and forward + backward, and of the density-only K4/K5 window pass of
    the same bins for comparison (``_median_ms``: one call between two
    CUDA events)."""
    import torch

    from nfs_tpu_torch.ops.binsplat import bin_particles, splat_binned, \
        to_binned
    from nfs_tpu_torch.ops.binsplat_kernels import splat_binned_window

    bn = bin_particles(x, P_GRID, K)
    pb = to_binned(bn, x)
    attr = torch.cat([to_binned(bn, dens)[None], to_binned(bn, color),
                      torch.ones_like(pb[:1])])
    g5 = torch.randn(P_GRID + (5,), device=x.device)
    g1 = g5[..., 0].contiguous()

    def fwd():
        return splat_binned(pb, attr, bn.valid, P_GRID, K)

    def fwd_bwd(window=False):
        p = pb.detach().requires_grad_(True)
        if window:
            a = attr[0].detach().requires_grad_(True)
            out, g = splat_binned_window(p, a, bn.valid, P_GRID, K), g1
        else:
            a = attr.detach().requires_grad_(True)
            out, g = splat_binned(p, a, bn.valid, P_GRID, K), g5
        return torch.autograd.grad(out, (p, a), g)

    return {"fwd_ms": _median_ms(fwd, runs=10),
            "fwd_bwd_ms": _median_ms(fwd_bwd, runs=10),
            "density_window_k4_k5_fwd_bwd_ms": _median_ms(
                lambda: fwd_bwd(True), runs=10)}


def _color_reference_run(dev: str, grid, eps: float = 0.0):
    """Colour keyframes at a small size (position + density + colour, a
    flat coarse octave and a binned finer one, keyframes 0 and 2 with
    frame 1 interpolated) on one device: (losses, [(x, dens, color)]).
    ``eps`` scales the positions by 1 + eps, to see how far the run
    carries a rounding-sized change."""
    import torch

    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.styler.particle import ParticleStyler

    rng = np.random.default_rng(6)
    x0 = (rng.random((1500, len(grid))) * (np.array(grid) - 4) + 2).astype(
        np.float32)
    col = rng.random((1500, 3), dtype=np.float32)
    col[:40, 0], col[40:80, 2] = 0.0, 1.0    # the clip's ties
    x0 = (x0 * np.float32(1 + eps)).astype(np.float32)
    frames = [ParticleSet(x=x0 + np.float32(0.1 * t),
                          dens=np.ones(1500, np.float32), color=col)
              for t in range(3)]
    cfg = _northstar_cfg(**{
        "render.render_size": (32, 32), "render.min_render_size": 16,
        "render.n_views": 2, "render.view_pool": 1, "render.transmit": 0.5,
        "loss.style_layers": ("relu1_1", "relu2_1"),
        "loss.style_layer_weights": (1.0, 1.0), "loss.w_style": 1000.0,
        "loss.features_dtype": "float32", "optim.octave_n": 2,
        "optim.octave_scale": 2.0, "optim.iters": 3, "optim.lr": 0.05,
        "particle.optimize_density": True, "particle.optimize_color": True,
        "particle.keyframe_stride": 2})
    styler = ParticleStyler(cfg, grid_shape=grid, style_image=rng.random(
        (32, 32, 3), dtype=np.float32), device=dev)
    outs = [(p.x.cpu().numpy(), p.dens.cpu().numpy(), p.color.cpu().numpy())
            for _, p in styler.stylize_keyframes(frames)]
    losses = torch.cat([torch.cat(i["octave_losses"]).cpu() for _, i in
                        sorted(styler.last_keyframe_infos.items())])
    return losses.numpy(), outs


def _reference_color(card: str):
    """Colour keyframes in 3D and 2D at a small size on the GPU (the
    5-channel generic binned pass, splat_normalized, the per-view colour
    render) against the same runs on the CPU, which
    tests/test_torch_particle_color.py holds against the JAX package; the
    style weight is 1000, as there."""
    err = {}
    for grid in ((16, 12, 16), (24, 18)):
        (lc, oc), (lg, og) = (_color_reference_run(dev, grid)
                              for dev in ("cpu", "cuda"))
        e = {"loss_rel": float(np.max(np.abs(lg - lc) / np.abs(lc)))}
        for i, k in enumerate(("x", "dens", "color")):
            e[k + "_max_abs"] = max(float(np.abs(g[i] - c[i]).max())
                                    for g, c in zip(og, oc))
        err["x".join(map(str, grid))] = e
        if not (all(np.isfinite(a).all() for o in og for a in o)
                and e["loss_rel"] <= 1e-4
                and max(v for k, v in e.items() if k != "loss_rel")
                <= 1e-3):
            raise AssertionError(f"colour GPU run departs from the CPU: "
                                 f"{grid} {e}")
    return {"vs": "cpu port", "err": err,
            "tol": {"loss_rel": 1e-4, "max_abs": 1e-3}}


def phase_color(card: str, root: str):
    """LNST colour at the particles_3d width (200 000 particles, 96x64x96,
    9 views, 256^2 renders, position + density + colour) on one keyframe,
    3 octaves x 4 iterations, run twice (the second timed); the binned
    colour pass alone at the finest octave; then a 2D particle run on the
    scene CLI's liquid2d frames (128x128, config #5's 2D grid, 3 frames,
    keyframes 0 and 2, 2 octaves x 5 iterations). The colour pass runs
    the generic binned splat, as the JAX package runs its XLA window
    there; the density-only coarse octaves' one splat runs K4."""
    import torch

    from nfs_tpu_torch.cli import scene
    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import binsplat_kernels as bk
    from nfs_tpu_torch.styler.particle import ParticleStyler

    iters = 4
    cfg = _particle_cfg(**{"particle.optimize_color": True,
                           "optim.iters": iters, "optim.log_every": 1})
    rng = np.random.default_rng(12)
    x = _particle_frames(1)[0]
    color = rng.random((P_COUNT, 3), dtype=np.float32)
    pset = ParticleSet(x=x, dens=np.ones(P_COUNT, np.float32), color=color)
    styler = ParticleStyler(cfg, grid_shape=P_GRID, style_image=rng.random(
        (256, 256, 3), dtype=np.float32), device="cuda")
    bk.reset_launches()
    walls, marks = [], []
    for _ in range(2):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        styled, param, info = styler.stylize_frame(
            pset, callback=lambda done, loss, octave: marks.append(
                (octave, done, time.perf_counter())))
        col = styled.color.cpu().numpy()
        walls.append(time.perf_counter() - t0)
    launches = dict(bk.LAUNCHES)
    finest = info["octave_losses"][-1].cpu().numpy()
    if not (col.shape == (P_COUNT, 3) and np.isfinite(col).all()
            and np.abs(col - color).max() > 0.0
            and np.isfinite(styled.x.cpu().numpy()).all()):
        raise AssertionError("colour keyframe: bad output")
    if not finest[-1] < finest[0]:
        raise AssertionError(f"colour: finest loss did not drop: {finest}")
    if launches["fwd"] <= 0:
        raise AssertionError(f"colour keyframe launched {launches}")
    K = next(iter(styler._k_cache.values()))[-1]
    if K is None:
        raise AssertionError("the colour keyframe's finest octave ran flat")
    dev = styler.device
    cpass = _color_pass_ms(torch.from_numpy(x).to(dev),
                           torch.ones(P_COUNT, device=dev),
                           torch.from_numpy(color).to(dev), K)
    s_iter = _octave_s_per_iter(marks, cfg.optim.octave_n - 1, iters)
    record = {"phase": "color", "particles": P_COUNT, "grid": list(P_GRID),
              "views": 9, "render": [256, 256],
              "attrs": sorted(param), "iters_per_octave": iters,
              "keyframe_s": walls[1], "first_run_s": walls[0],
              "finest_s_per_iter": s_iter, "finest_K": K,
              "color_pass": cpass,
              "color_pass_fwd_bwd_share_of_finest_iter":
                  cpass["fwd_bwd_ms"] / 1e3 / s_iter,
              "launches": launches,
              "reduced": f"one keyframe, {iters} iterations per octave "
                         "(particles_3d: 20)"}

    data = os.path.join(root, "liquid2d")
    with contextlib.redirect_stdout(io.StringIO()):
        scene.main(["--scene", "liquid2d", "--out", data, "--res",
                    *map(str, LIQUID2D_GRID), "--frames", "3"])
    store = FrameStore(data)
    frames = [store.load_particles(t) for t in range(3)]
    cfg2 = _particle_cfg(**{"particle.optimize_color": True,
                            "particle.keyframe_stride": 2,
                            "optim.octave_n": 2, "optim.iters": 5})
    styler2 = ParticleStyler(cfg2, grid_shape=LIQUID2D_GRID,
                             style_image=rng.random((256, 256, 3),
                                                    dtype=np.float32),
                             device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [(t, p.x.cpu().numpy(), p.color.cpu().numpy()) for t, p in
            styler2.stylize_keyframes([ParticleSet(x=f["x"], dens=f["dens"])
                                       for f in frames])]
    wall2 = time.perf_counter() - t0
    n2 = frames[0]["x"].shape[0]
    for t, xo, co in outs:
        if not (xo.shape == (n2, 2) and co.shape == (n2, 3)
                and np.isfinite(xo).all() and np.isfinite(co).all()):
            raise AssertionError(f"2D particle frame {t}: bad output")
    if [t for t, _, _ in outs] != [0, 1, 2]:
        raise AssertionError("2D particle frames out of order")
    record["liquid2d"] = {
        "grid": list(LIQUID2D_GRID), "particles": n2, "frames": 3,
        "keyframes": sorted(styler2.last_keyframe_infos),
        "wall_s": wall2, "s_per_iter_incl_warmup": wall2 / (2 * 2 * 5),
        "reduced": "3 frames, 2 octaves x 5 iterations (config #5's 2D "
                   "bench: 30)"}
    record["reference"] = _reference_color(card)
    record["card"] = card
    emit(record)


def _transfer_gather_reference_run(dev: str, eps: float = 0.0):
    """A 3D W=1 frame at a small size with rotation='gather' and the
    'fire' transfer function trained, on one device: (losses, d_star,
    field, nodes). ``eps`` scales the density by 1 + eps."""
    from nfs_tpu_torch.styler.grid import GridStyler

    shape = (16, 12, 16)
    rng = np.random.default_rng(8)
    d = (_plume_density(shape, 0, rng) * np.float32(1 + eps))[None]
    v = (0.7 * rng.standard_normal((1,) + shape + (3,))).astype(np.float32)
    cfg = _northstar_cfg(**{
        "render.render_size": (32, 32), "render.min_render_size": 16,
        "render.n_views": 2, "render.view_pool": 1, "render.transmit": 0.5,
        "render.rotation": "gather", "render.transfer_fn": "fire",
        "render.train_transfer": True,
        "loss.style_layers": ("relu1_1", "relu2_1"),
        "loss.style_layer_weights": (1.0, 1.0), "loss.w_style": 1000.0,
        "loss.features_dtype": "float32", "optim.octave_n": 2,
        "optim.octave_scale": 2.0, "optim.iters": 3})
    styler = GridStyler(cfg, style_image=rng.random(
        (32, 32, 3), dtype=np.float32), device=dev)
    (_, d_star, param), = styler.stylize_sequence(d, v, fused=0)
    return (styler.frame_losses[0].cpu().numpy().ravel(),
            d_star.cpu().numpy(), param["field"].cpu().numpy(),
            param["tf"].cpu().numpy())


def _reference_transfer_gather(card: str):
    """The gather rotation and the trained transfer function at a small
    size on the GPU (K1 and K2 in the window loss) against the same run on
    the CPU, which tests/test_torch_grid2d.py holds against the JAX
    package; the style weight is 1000, as there."""
    (lc, *oc), (lg, *og) = (_transfer_gather_reference_run(dev)
                            for dev in ("cpu", "cuda"))
    err = {"loss_rel": float(np.max(np.abs(lg - lc) / np.abs(lc)))}
    for k, g, c in zip(("d_star", "field", "tf"), og, oc):
        err[k + "_max_abs"] = float(np.abs(g - c).max())
    if not (all(np.isfinite(a).all() for a in og)
            and err["loss_rel"] <= 1e-4
            and max(v for k, v in err.items() if k != "loss_rel") <= 1e-3):
        raise AssertionError(f"gather + transfer GPU run departs from the "
                             f"CPU: {err}")
    return {"shape": [16, 12, 16], "vs": "cpu port", "err": err,
            "tol": {"loss_rel": 1e-4, "max_abs": 1e-3}}


def phase_transfer_gather(card: str):
    """The density slice's first frame (112x64x112, W=1, config #3
    widths, 3 octaves x 8 iterations) coloured by the 'fire' transfer
    function with its control points trained (render.train_transfer),
    then the same frame with rotation='gather' (the exact trilinear
    resample through ops/interp.grid_sample) in place of the shears.
    Each frame runs twice and the second run is timed and checked, with
    the launches of that run. Gather and shear give different images, so
    the two are not compared with each other; a small gather frame with
    a trained transfer function is compared with the CPU port."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.render.transfer import COLORMAPS
    from nfs_tpu_torch.styler.grid import GridStyler

    rng = np.random.default_rng(4)
    ds = _plume_density(SHAPE, 0, rng)[None]
    vs = _swirl_velocity(SHAPE, 0)[None]
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    record = {"phase": "transfer_gather", "shape": list(SHAPE), "card": card,
              "reduced": "one frame, 8 iterations per octave (config #3: "
                         "20)"}
    for rotation in ("shear", "gather"):
        cfg = _northstar_cfg(**{"optim.iters": 8,
                                "render.transfer_fn": "fire",
                                "render.train_transfer": True,
                                "render.rotation": rotation})
        styler = GridStyler(cfg, style_image=style, device="cuda")
        for _ in range(2):
            marks = []
            ak.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (_, d_star, param), = styler.stylize_sequence(
                ds, vs, fused=0, callback=lambda done, loss, octave:
                marks.append((octave, done, time.perf_counter())))
            out = d_star.cpu().numpy()
            wall = time.perf_counter() - t0
        launches = dict(ak.LAUNCHES)
        nodes = torch.clamp(param["tf"], 0, 1).cpu().numpy()
        _check_grid_out(rotation, out, ds[0])
        if not (np.isfinite(nodes).all()
                and np.abs(nodes - COLORMAPS["fire"]).max() > 0.0):
            raise AssertionError(f"{rotation}: the nodes did not train")
        if launches["fwd"] <= 0 or launches["bwd_field"] <= 0:
            raise AssertionError(f"{rotation} launched {launches}")
        losses = styler.frame_losses[0].cpu().numpy()
        record[rotation] = {
            "wall_s": wall, "finest_s_per_iter": _octave_s_per_iter(
                marks, cfg.optim.octave_n - 1, cfg.optim.iters),
            "finest_losses": losses[-1].tolist(),
            "max_node_move": float(np.abs(nodes - COLORMAPS["fire"]).max()),
            "launches": launches}
    record["gather_minus_shear_finest_s_per_iter"] = (
        record["gather"]["finest_s_per_iter"]
        - record["shear"]["finest_s_per_iter"])
    record["reference"] = _reference_transfer_gather(card)
    emit(record)


def phase_checkpoint(card: str, root: str, data_dir: str):
    """In-frame checkpoints on the velocity slice's first frame (config
    #4, 112x64x112, W=1, 2 octaves x 4 iterations, log_every 2, so K1, K2
    and K3 run): the frame twice without interruption, then through
    ``stylize_frame(checkpoint_path=)`` interrupted by a callback raising
    after the first chunk of octave 1 (its checkpoint written), and
    resumed. If the two uninterrupted runs are bitwise equal, the resumed
    one must be too; if not, their gap is printed and the resumed run
    held to it. Then a
    ``--checkpoint_in_frame`` CLI job on one of the scene's frames, which
    must complete and leave no checkpoint file."""
    import torch

    from nfs_tpu_torch.cli.stylize import main as stylize
    from nfs_tpu_torch.io.checkpoint import read_meta
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.styler.grid import GridStyler

    class Interrupt(Exception):
        pass

    def stop(done, loss, octave):
        if (octave, done) == (1, 2):
            raise Interrupt

    cfg = _northstar_cfg(**{"optim.parameterization": "velocity",
                            "optim.octave_n": 2, "optim.iters": 4,
                            "optim.log_every": 2})
    styler = GridStyler(cfg, style_image=np.random.default_rng(2).random(
        (256, 256, 3), dtype=np.float32), device="cuda")
    d = _plume_density(SHAPE, 0, np.random.default_rng(3))
    v = _swirl_velocity(SHAPE, 0)
    vels = np.stack([v, v])     # frame 0's W=1 context
    ckpt = os.path.join(root, "inframe_ckpt.npz")
    ak.reset_launches()
    runs, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        d_star, param, _ = styler.stylize_frame(d, vels=vels)
        runs.append((d_star.cpu().numpy(), param.cpu().numpy()))
        walls.append(time.perf_counter() - t0)
    try:
        styler.stylize_frame(d, vels=vels, checkpoint_path=ckpt,
                             callback=stop)
        raise AssertionError("the interrupting callback never ran")
    except Interrupt:
        pass
    meta = read_meta(ckpt)
    if (meta["octave"], meta["iters_done"]) != (1, 2):
        raise AssertionError(f"checkpoint at {meta}")
    t0 = time.perf_counter()
    d_star, param, info = styler.stylize_frame(d, vels=vels,
                                               checkpoint_path=ckpt)
    resumed = (d_star.cpu().numpy(), param.cpu().numpy())
    resume_s = time.perf_counter() - t0
    launches = dict(ak.LAUNCHES)
    if os.path.exists(ckpt):
        raise AssertionError("the completed frame left its checkpoint")
    if [len(l) for l in info["octave_losses"]] != [2]:
        raise AssertionError(f"resumed losses {info['octave_losses']}")
    gap = max(float(np.abs(a - b).max()) for a, b in zip(*runs))
    off = max(float(np.abs(a - b).max()) for a, b in zip(resumed, runs[0]))
    if not off <= gap:
        raise AssertionError(f"resumed run {off} from the uninterrupted, "
                             f"two uninterrupted runs {gap} apart")
    if not (launches["fwd"] > 0 and launches["bwd_field"] > 0
            and launches["bwd_vel"] > 0):
        raise AssertionError(f"velocity checkpoint path launched {launches}")
    f32 = _phase_checkpoint_f32(cfg, d, vels, root, stop, Interrupt)

    log = os.path.join(root, "log")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        stylize(["--data_dir", data_dir, "--log_dir", log, "--tag", "ckpt",
                 "--checkpoint_in_frame", "--octave_n", "2", "--iter", "2"])
    cli_s = time.perf_counter() - t0
    out_dir = os.path.join(log, "ckpt")
    if os.path.exists(os.path.join(out_dir, "inframe_ckpt.npz")):
        raise AssertionError("the CLI job left its in-frame checkpoint")
    out = FrameStore(out_dir).load_density(0)
    if not (out.shape == SHAPE and np.isfinite(out).all()):
        raise AssertionError("the CLI job wrote a bad frame")
    emit({"phase": "checkpoint", "shape": list(SHAPE),
          "parameterization": "velocity", "octave_n": 2, "iters": 4,
          "log_every": 2, "interrupted_at": meta,
          "uninterrupted_runs_bitwise_equal": gap == 0.0,
          "uninterrupted_gap_max_abs": gap,
          "resumed_vs_uninterrupted_max_abs": off,
          "frame_s": walls, "resume_s": resume_s, "launches": launches,
          "float32_features": f32,
          "cli": {"wall_s": cli_s, "checkpoint_left": False},
          "card": card})


def _phase_checkpoint_f32(cfg, d, vels, root: str, stop, interrupt):
    """The checkpoint phase's frame at float32 features, where cuDNN's
    default convolution algorithms differ from run to run: two runs with
    the defaults (their gap), two inside the styler's deterministic scope
    without a checkpoint (its cost in s/iter), one with a checkpoint
    (which runs in that scope), then that frame interrupted after octave
    1's first chunk and resumed, which must give the checkpointed run's
    bits."""
    import torch

    from nfs_tpu_torch.core.config import replace
    from nfs_tpu_torch.styler.grid import GridStyler, _deterministic_convs

    styler = GridStyler(replace(cfg, **{"loss.features_dtype": "float32"}),
                        style_image=np.random.default_rng(2).random(
                            (256, 256, 3), dtype=np.float32),
                        device="cuda")
    n_iter = cfg.optim.octave_n * cfg.optim.iters
    ckpt = os.path.join(root, "inframe_ckpt_f32.npz")

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_star, param, _ = styler.stylize_frame(d, vels=vels, **kw)
        torch.cuda.synchronize()
        return d_star, param, (time.perf_counter() - t0) / n_iter

    default = [timed() for _ in range(2)]
    with _deterministic_convs():
        det = [timed() for _ in range(2)]
    ref = timed(checkpoint_path=ckpt)
    try:
        styler.stylize_frame(d, vels=vels, checkpoint_path=ckpt,
                             callback=stop)
        raise AssertionError("the interrupting callback never ran")
    except interrupt:
        pass
    resumed = timed(checkpoint_path=ckpt)
    if os.path.exists(ckpt):
        raise AssertionError("the completed f32 frame left its checkpoint")
    if not (torch.equal(resumed[0], ref[0])
            and torch.equal(resumed[1], ref[1])):
        raise AssertionError(
            f"float32 features: the resumed frame differs from the "
            f"uninterrupted one by {float((resumed[0] - ref[0]).abs().max())}")
    if not (torch.equal(det[0][0], det[1][0])
            and torch.equal(det[0][0], ref[0])):
        raise AssertionError("float32 features: two deterministic runs "
                             "differ")
    return {"resumed_bitwise": True,
            "default_runs_gap_max_abs":
                float((default[0][0] - default[1][0]).abs().max()),
            "s_per_iter_default": [r[2] for r in default],
            "s_per_iter_deterministic": [r[2] for r in det],
            "s_per_iter_checkpointed": ref[2]}


def _exact_inputs(case: str):
    """Field, cotangent and velocity at SHAPE for the exact-path phase:
    'swirl' is the density slice's swirl (|v| <= 1.5 cells), 'far' a
    random velocity clipped to +-6 cells per component, the range the
    exact path exists for."""
    f, g, v = _kernel_inputs("swirl", 2.0, seed=31)
    if case == "far":
        rng = np.random.default_rng(32)
        v = np.clip(2.5 * rng.standard_normal(SHAPE + (3,)), -6.0,
                    6.0).astype(np.float32)
    return f, g, v


def _exact_value_and_grads(fn, f, g, v, dev: str):
    """fn(field, vel) with both gradients of sum(fn * g), on ``dev``."""
    import torch

    ft = torch.from_numpy(f).to(dev).requires_grad_()
    vt = torch.from_numpy(v).to(dev).requires_grad_()
    out = fn(ft, vt)
    gf, gv = torch.autograd.grad(out, (ft, vt), torch.from_numpy(g).to(dev))
    return tuple(x.detach().cpu() for x in (out, gf, gv))


def _exact_styler_run(cfg, style, ds, vs):
    """A GridStyler sequence on the card: (per-frame outputs, per-frame
    losses, s/iter over the frames after the first)."""
    import torch

    from nfs_tpu_torch.styler.grid import GridStyler

    styler = GridStyler(cfg, style_image=style, device="cuda")
    marks, outs = [time.perf_counter()], []
    for _, d_star, param in styler.stylize_sequence(ds, vs, fused=0):
        outs.append((d_star.cpu().numpy(), param.cpu().numpy()))
        marks.append(time.perf_counter())
    torch.cuda.synchronize()
    losses = [styler.frame_losses[t].cpu().numpy() for t in range(len(ds))]
    per_frame = cfg.optim.octave_n * cfg.optim.iters
    steady = (float(np.diff(marks)[1:].mean()) / per_frame
              if len(ds) > 1 else (marks[-1] - marks[0]) / per_frame)
    return outs, losses, steady


def phase_exact(card: str):
    """The exact advection path (max_disp=None), which runs no hand
    kernel (a gather forward and one index_add for the field gradient,
    ops/interp.py): advect and advect_maccormack at 112x64x112 on the
    swirl and on a velocity of up to 6 cells, values and both gradients
    on the card held against the CPU port (values 1e-5; gradients 1e-4:
    index_add sums in another order on the card), timed beside K1 and
    K1 + K2 (the window path at max_disp 2 through the same ``advect``);
    then a density sequence (W=1, 2 frames) and a velocity frame (config
    #4, 2 octaves x 3) with optim.max_disp and param_max_disp None,
    which must be finite, lower the loss within an octave of frame 0
    and launch no K1-K3."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops.advect import advect, advect_maccormack

    fns = {
        "advect": lambda f, v: advect(f, v, max_disp=None),
        "maccormack": lambda f, v: advect_maccormack(f, v, max_disp=None),
    }
    tol = {"value": 1e-5, "grad": 1e-4}
    errs = {}
    for case in ("swirl", "far"):
        f, g, v = _exact_inputs(case)
        for name, fn in fns.items():
            gpu = _exact_value_and_grads(fn, f, g, v, "cuda")
            cpu = _exact_value_and_grads(fn, f, g, v, "cpu")
            e = [float((a - b).abs().max()) for a, b in zip(gpu, cpu)]
            errs[f"{name}_{case}"] = {"value": e[0], "grad_field": e[1],
                                      "grad_vel": e[2]}
            if not (all(_all_finite(x) for x in gpu) and e[0] <= tol["value"]
                    and max(e[1:]) <= tol["grad"]):
                raise AssertionError(f"exact {name} on {case}: card vs CPU "
                                     f"port {errs[f'{name}_{case}']}")

    # times: the exact path and the window path (K1, K1 + K2) through the
    # same advect, on the swirl
    f, g, v = (torch.from_numpy(a).cuda() for a in _exact_inputs("swirl"))
    fr = f.clone().requires_grad_()

    def fwd_bwd(md):
        return lambda: torch.autograd.grad(advect(fr, v, max_disp=md), fr, g)

    times = {}
    for label, fn in (("exact_fwd", lambda: advect(f, v, max_disp=None)),
                      ("exact_fwd_bwd_field", fwd_bwd(None)),
                      ("k1_fwd", lambda: advect(f, v, max_disp=2.0)),
                      ("k1_k2_fwd_bwd_field", fwd_bwd(2.0))):
        times[label] = {"ms": _median_ms(fn), "device_ms": _device_ms(fn)}

    rng = np.random.default_rng(33)
    style = rng.random((256, 256, 3), dtype=np.float32)
    ds = np.stack([_plume_density(SHAPE, t, rng) for t in range(2)])
    vs = np.stack([_exact_inputs("far")[2], _swirl_velocity(SHAPE, 1)])
    exact = {"optim.max_disp": None, "optim.param_max_disp": None}
    runs = {}
    for label, cfg, frames in (
            ("density", _northstar_cfg(**exact, **{"optim.iters": 3}), 2),
            ("velocity", _northstar_cfg(**exact, **{
                "optim.parameterization": "velocity", "optim.octave_n": 2,
                "optim.iters": 3}), 1)):
        ak.reset_launches()
        outs, losses, s_iter = _exact_styler_run(cfg, style, ds[:frames],
                                                 vs[:frames])
        launches = dict(ak.LAUNCHES)
        if any(launches[k] for k in ("fwd", "bwd_field", "bwd_vel",
                                     "bwd_fused", "bwd_field_untiled")):
            raise AssertionError(f"exact {label} run launched {launches}")
        for t, (d_star, param) in enumerate(outs):
            if not (d_star.shape == SHAPE and np.isfinite(d_star).all()
                    and np.isfinite(param).all()):
                raise AssertionError(f"exact {label} frame {t}: bad output")
        # Adam's fresh first step of an octave moves every cell by lr,
        # which can raise the loss for a step (the velocity run's finest
        # octave did on the H100), so the drop is asked of some octave
        if not any(o[-1] < o[0] for o in losses[0]):
            raise AssertionError(f"exact {label}: no octave of frame 0 "
                                 f"lowered its loss: {losses[0]}")
        runs[label] = {"frames": frames, "octave_n": cfg.optim.octave_n,
                       "iters": cfg.optim.iters, "s_per_iter": s_iter,
                       "octave_losses_frame0": losses[0].tolist(),
                       "launches": launches}
    emit({"phase": "exact", "shape": list(SHAPE),
          "max_abs_err_vs_cpu_port": errs, "tol": tol, "times": times,
          "runs": runs,
          "note": "velocity 'far' up to 6 cells per component; s_per_iter "
                  "of frame 1 (density) or of the one frame, warm-up "
                  "included (velocity)", "card": card})


def phase_remat(card: str):
    """loss.remat_views at the density slice's frame 0 (W=1, 112x64x112,
    9 views, bf16, relu1_1-relu4_1) at 512^2 renders, one octave x 3
    iterations, without and with per-view rematerialization: peak device
    memory (``max_memory_allocated`` after ``reset_peak_memory_stats``)
    and s/iter of each (steady: iterations 2-3); the peak with remat must be the lower. The two
    runs compute the same loss (a mean over views either way), with
    cuDNN's bf16 convolutions batched differently: the first iteration's
    loss within 1e-3 relative, every loss within 1e-2 and d* within
    0.06 (half the 0.12 that 3 Adam steps of lr 0.02 can open). Returns
    the remat run's losses."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.styler.grid import GridStyler

    rng = np.random.default_rng(0)
    d = _plume_density(SHAPE, 0, rng)
    vels = np.stack([_swirl_velocity(SHAPE, 0)] * 2)
    style = np.random.default_rng(1).random((512, 512, 3), dtype=np.float32)
    runs = {}
    for remat in (False, True):
        cfg = _northstar_cfg(**{"render.render_size": (512, 512),
                                "optim.octave_n": 1, "optim.iters": 3,
                                "loss.remat_views": remat})
        styler = GridStyler(cfg, style_image=style, device="cuda")
        ak.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the callback reads each iteration's loss (log_every=1), which
        # synchronises: iterations 2-3 give the steady s/iter (the first
        # also imports what torch.utils.checkpoint needs)
        marks = []
        t0 = time.perf_counter()
        d_star, _, info = styler.stylize_frame(
            d, vels=vels, callback=lambda done, loss, octave: marks.append(
                time.perf_counter()))
        d_star = d_star.cpu().numpy()     # synchronises
        seconds = time.perf_counter() - t0
        runs[remat] = {
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "s_per_iter_incl_warmup": seconds / cfg.optim.iters,
            "s_per_iter_steady": (marks[-1] - marks[0]) / (len(marks) - 1),
            "losses": info["octave_losses"][0].cpu().numpy(),
            "d_star": d_star, "launches": dict(ak.LAUNCHES)}
        del styler
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    first_rel = float(abs(on["losses"][0] / off["losses"][0] - 1.0))
    loss_rel = float(np.max(np.abs(on["losses"] / off["losses"] - 1.0)))
    d_err = float(np.abs(on["d_star"] - off["d_star"]).max())
    for r in (off, on):
        if not (np.isfinite(r["d_star"]).all() and r["launches"]["fwd"] > 0
                and r["launches"]["bwd_field"] > 0):
            raise AssertionError(f"remat phase: bad run {r['launches']}")
    if not on["peak_bytes"] < off["peak_bytes"]:
        raise AssertionError(f"remat peak {on['peak_bytes']} not below "
                             f"{off['peak_bytes']}")
    if not (first_rel <= 1e-3 and loss_rel <= 1e-2 and d_err <= 0.06):
        raise AssertionError(f"remat departs from the batched loss: first "
                             f"{first_rel}, losses {loss_rel}, d* {d_err}")
    emit({"phase": "remat", "shape": list(SHAPE), "render_size": [512, 512],
          "n_views": 9, "window": 1, "octave_n": 1, "iters": 3,
          "peak_gib": {"batched": off["peak_bytes"] / 2 ** 30,
                       "remat": on["peak_bytes"] / 2 ** 30},
          "s_per_iter_incl_warmup": {
              "batched": off["s_per_iter_incl_warmup"],
              "remat": on["s_per_iter_incl_warmup"]},
          "s_per_iter_steady": {"batched": off["s_per_iter_steady"],
                                "remat": on["s_per_iter_steady"]},
          "losses": {"batched": off["losses"].tolist(),
                     "remat": on["losses"].tolist()},
          "err": {"first_loss_rel": first_rel, "loss_rel": loss_rel,
                  "d_star_max_abs": d_err},
          "tol": {"first_loss_rel": 1e-3, "loss_rel": 1e-2,
                  "d_star_max_abs": 0.06},
          "launches": {"batched": off["launches"],
                       "remat": on["launches"]}, "card": card})
    return on["losses"]


class _FirstIteration(Exception):
    """Raised by a callback to stop a run after its first iteration."""


def _engine_first_loss(cfg, style, ds, vs, device: str) -> float:
    """The loss of the joint engine's first iteration (coarsest octave;
    ``cfg`` has log_every 1) on ``device``."""
    from nfs_tpu_torch.parallel import ParallelSequenceStyler, make_mesh
    from nfs_tpu_torch.styler.grid import GridStyler

    first = []

    def stop(done, loss, octave):
        first.append(loss)
        raise _FirstIteration

    engine = ParallelSequenceStyler(
        GridStyler(cfg, style_image=style, device=device), make_mesh(1, 1))
    try:
        engine.stylize(ds, vs, callback=stop)
    except _FirstIteration:
        pass
    return first[0]


def phase_parallel(card: str, root: str, smoke_dir: str):
    """The joint sequence engine (``parallel.ParallelSequenceStyler``) on a
    (1, 1) mesh at the density slice's config (5 iterations per octave)
    over T = 8 of the scene's smoke3d frames: a warm-up run, a timed run
    (s/iter, s/frame, peak memory), T = 2 (its peak memory too, for the
    GiB per frame; K1 and K2 launches per iteration must not depend on
    T: 2 each at W = 1), the same T = 8 run
    inside a 1-rank NCCL process group (its collectives run on CUDA
    tensors; bitwise the run without a group), the streaming styler on
    the same frames (s/frame; another algorithm, so timing only), the
    first iteration's loss on frames 0-1 against the CPU port (float32
    features), config #4 through the engine at T = 2 (K1, K2, K3
    batched), and one ``cli.stylize --parallel`` run. Returns the
    launches of the T = 8 density run and of the velocity run."""
    import torch
    import torch.distributed as dist

    from nfs_tpu_torch.cli.stylize import main as stylize
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.parallel import ParallelSequenceStyler, make_mesh
    from nfs_tpu_torch.styler.grid import GridStyler

    T, iters = 8, 5
    store = FrameStore(smoke_dir)
    ds = np.stack([store.load_density(t) for t in range(T)])
    vs = np.stack([store.load_velocity(t) for t in range(T)])
    cfg = _northstar_cfg(**{"optim.iters": iters})
    n_iter = iters * cfg.optim.octave_n
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    styler = GridStyler(cfg, style_image=style, device="cuda")

    def run(n, mesh=None):
        engine = ParallelSequenceStyler(styler, mesh or make_mesh(1, 1))
        ak.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, p, info = engine.stylize(ds[:n], vs[:n])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, d, info, dict(ak.LAUNCHES),
                engine.last_collectives)

    run(T)                                          # warm-up
    torch.cuda.reset_peak_memory_stats()
    wall, d_star, info, launches, _ = run(T)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    wall2, _, _, launches2, _ = run(2)
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 30
    for n, got in ((T, launches), (2, launches2)):
        per_iter = {k: got[k] / n_iter for k in ("fwd", "bwd_field")}
        if per_iter != {"fwd": 2.0, "bwd_field": 2.0} or got["bwd_vel"]:
            raise AssertionError(f"T={n}: launches {got} in {n_iter} "
                                 f"iterations, not 2 K1 and 2 K2 each")
    d_np = d_star.cpu().numpy()
    if d_np.shape != (T,) + SHAPE or not np.isfinite(d_np).all() \
            or d_np.min() < 0.0:
        raise AssertionError(f"engine output {d_np.shape}, min "
                             f"{d_np.min()}")
    losses = [l.cpu().numpy() for l in info["octave_losses"]]
    if not any(l[-1] < l[0] for l in losses):
        raise AssertionError(f"no octave's loss fell: {losses}")

    # a 1-rank NCCL group: the all_reduces and gathers run on the card
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        _, d_nccl, _, _, collectives = run(T, make_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    if not torch.equal(d_nccl, d_star):
        raise AssertionError(
            f"the run in a 1-rank NCCL group differs from the run without "
            f"one: {float((d_nccl - d_star).abs().max())}")
    if collectives["all_reduce"] != n_iter + cfg.optim.octave_n:
        raise AssertionError(f"NCCL run collectives {collectives}")

    # the streaming styler on the same frames, timed alike
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    for _ in styler.stylize_sequence(ds, vs, fused=0):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    stream_s = np.diff(marks)

    # the first iteration on the card against the CPU port, frames 0-1
    f32 = _northstar_cfg(**{"optim.iters": iters,
                            "loss.features_dtype": "float32"})
    first = {dev: _engine_first_loss(f32, style, ds[:2], vs[:2], dev)
             for dev in ("cuda", "cpu")}
    first_rel = abs(first["cuda"] - first["cpu"]) / abs(first["cpu"])
    if not first_rel <= 1e-4:
        raise AssertionError(f"first iteration card {first['cuda']} vs "
                             f"CPU {first['cpu']}")

    # config #4 (velocity) through the engine: K1, K2 and K3 batched
    vcfg = _northstar_cfg(**{"optim.parameterization": "velocity",
                             "optim.octave_n": 2, "optim.iters": 3})
    vengine = ParallelSequenceStyler(
        GridStyler(vcfg, style_image=style, device="cuda"),
        make_mesh(1, 1))
    ak.reset_launches()
    vd, vp, _ = vengine.stylize(ds[:2], vs[:2])
    torch.cuda.synchronize()
    vel_launches = dict(ak.LAUNCHES)
    # per iteration: K1 for d* and the two taps, K2 for the taps, K3 for
    # d*'s velocity; plus K1 for the final d*
    if vel_launches["fwd"] != 3 * 6 + 1 or vel_launches["bwd_field"] != \
            2 * 6 or vel_launches["bwd_vel"] != 6:
        raise AssertionError(f"velocity engine launches {vel_launches}")
    if not (torch.isfinite(vp).all() and float(vp.abs().max()) > 0.0
            and tuple(vp.shape) == (2,) + SHAPE + (3,)):
        raise AssertionError("velocity engine output")

    # the CLI: 4 frames, 2 octaves x 2 iterations
    style_path = os.path.join(root, "parallel_style.npy")
    np.save(style_path, style)
    log = os.path.join(root, "parallel_log")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        stylize(["--data_dir", smoke_dir, "--log_dir", log, "--tag", "par",
                 "--style_target", style_path, "--num_frames", "4",
                 "--window", "1", "--octave_n", "2", "--iter", "2",
                 "--parallel"])
    cli_s = time.perf_counter() - t0
    out = FrameStore(os.path.join(log, "par"))
    with open(os.path.join(log, "par", "metrics.jsonl")) as f:
        metric = json.loads(f.readline())
    if not (all(np.isfinite(out.load_density(t)).all() for t in range(4))
            and metric["mesh"] == {"frames": 1, "views": 1}
            and "[parallel] 4 frames" in buf.getvalue()):
        raise AssertionError(f"cli --parallel: {metric} {buf.getvalue()}")

    emit({"phase": "parallel", "frames": T, "shape": list(SHAPE),
          "mesh": [1, 1], "window": cfg.optim.window,
          "reduced": f"optim.iters {iters} per octave (config #3: 20), "
                     f"{T} frames (north star: 200); random VGG weights "
                     f"and style",
          "joint_s_per_iter": wall / n_iter, "joint_s_per_frame": wall / T,
          "joint_wall_s": wall, "t2_wall_s": wall2,
          "peak_gib": peak, "peak_gib_t2": peak2,
          "gib_per_frame": (peak - peak2) / (T - 2),
          "launches_t8": launches, "launches_t2": launches2,
          "k1_k2_per_iter": 2, "octave_losses": [l.tolist() for l in losses],
          "nccl_1_rank_bitwise": True, "nccl_collectives": collectives,
          "streaming_s_per_frame": float(stream_s[1:].mean()),
          "streaming_frame_s": stream_s.tolist(),
          "first_iter_loss": first, "first_iter_rel": first_rel,
          "tol": {"first_iter_rel": 1e-4},
          "velocity_t2_launches": vel_launches, "cli_wall_s": cli_s,
          "card": card})
    return launches, vel_launches


# the spatial phase: the y-slabs of 2 and 4 space ranks (the octave y
# sizes 64, 36 and 20 divide by both)
SPACE_SIZES = (2, 4)
SLAB_TOL = {"bwd_field": 1e-4}
# name: (max_disp, gradients taken, FUSED_BWD, frames in a batch (0: one
# volume), each slab's launches): K1 + K2 at the window's max_disp 2, K1 +
# K3 at the velocity parameter's param_max_disp 1, K1 + K3b, and a batch
# of two frames through K1 + K2 + K3 as the engine advects its frames
SLAB_RUNS = {
    "field": (2.0, ("field",), False, 0, {"fwd": 1, "bwd_field": 1}),
    "vel": (1.0, ("vel",), False, 0, {"fwd": 1, "bwd_vel": 1}),
    "fused": (2.0, ("field", "vel"), True, 0, {"fwd": 1, "bwd_fused": 1}),
    "batched": (2.0, ("field", "vel"), False, 2,
                {"fwd": 1, "bwd_field": 1, "bwd_vel": 1}),
}


def _slab_run(f, v, g, md: float, n: int, grads, lead: int):
    """``SpaceSlabs.advect`` itself on each of the ``n`` y-slabs of (f, v),
    forward and the gradients ``grads`` of the cotangent g, the slabs run
    one after another in this process (``parallel.spatial.run_slabs``:
    the halo rows a rank would receive come from the slab that sent
    them). Returns the outputs assembled into the volume and each slab's
    kernel launches in the round whose results are kept."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.parallel.spatial import SpaceSlabs, run_slabs

    def one(ring):
        space = SpaceSlabs(None, f.shape[lead:], lead=lead, ring=ring)
        fs = space.slab(f).requires_grad_("field" in grads)
        vs = space.slab(v).requires_grad_("vel" in grads)
        before = dict(ak.LAUNCHES)
        y = space.advect(fs, vs, max_disp=md)
        outs = (y.detach(),) + torch.autograd.grad(
            y, [t for t in (fs, vs) if t.requires_grad], space.slab(g))
        return outs, {k: c - before[k] for k, c in ak.LAUNCHES.items()
                      if c != before[k]}

    results = run_slabs(one, n)
    whole = [torch.cat(parts, dim=lead + 1)
             for parts in zip(*(r[0] for r in results))]
    return whole, [r[1] for r in results]


def _far_rows(H: int, n: int, md: float):
    """The rows of an H-row volume on n slabs whose field gradient takes
    nothing from another slab: ceil(md) rows or more from every cut."""
    r, h = int(math.ceil(md)), H // n
    return [y for y in range(H) if (y % h >= r or y < h)
            and (h - 1 - y % h >= r or y >= H - h)]


def _slab_checks(card: str):
    """(1) of :func:`phase_spatial`: one record per (run, space size)."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops.advect import advect, advect_frames

    H = SHAPE[1]
    slabs = []
    for name, (md, grads, fused, frames, per_slab) in SLAB_RUNS.items():
        inputs = [_cuda_inputs("random", md, seed=11 + i)
                  for i in range(max(frames, 1))]
        f, g, v = (torch.stack(x) if frames else x[0]
                   for x in zip(*inputs))
        lead = 1 if frames else 0
        fused_before, ak.FUSED_BWD = ak.FUSED_BWD, fused
        try:
            fw = f.clone().requires_grad_("field" in grads)
            vw = v.clone().requires_grad_("vel" in grads)
            y = (advect_frames if frames else advect)(fw, vw, max_disp=md)
            want = [y.detach()] + list(torch.autograd.grad(
                y, [t for t in (fw, vw) if t.requires_grad], g))
            for n in SPACE_SIZES:
                got, launches = _slab_run(f, v, g, md, n, grads, lead)
                torch.cuda.synchronize()
                if launches != [per_slab] * n:
                    raise AssertionError(f"{name} on {n} slabs launched "
                                         f"{launches}")
                errs = {}
                labels = ["out"] + [k for k in ("field", "vel")
                                    if k in grads]
                far = _far_rows(H, n, md)
                for label, a, b in zip(labels, got, want):
                    err = float((a - b).abs().max())
                    errs[label] = err
                    if label == "field":
                        if not err <= SLAB_TOL["bwd_field"]:
                            raise AssertionError(f"{name} on {n} slabs: "
                                                 f"field gradient {err}")
                        if not torch.equal(a[..., far, :], b[..., far, :]):
                            raise AssertionError(
                                f"{name} on {n} slabs: the field "
                                f"gradient differs away from the cuts")
                    elif err != 0.0:
                        raise AssertionError(
                            f"{name} on {n} slabs: {label} differs from "
                            f"the whole volume by {err}")
                slabs.append({"run": name, "space": n, "max_disp": md,
                              "frames": frames, "launches_per_slab":
                              per_slab, "max_abs_err": errs})
        finally:
            ak.FUSED_BWD = fused_before
    return slabs


def phase_spatial(card: str):
    """Spatial sharding (``parallel/spatial.py``) at the density slice's
    full width. (1) One process, space 2 and 4 (:func:`_slab_checks`):
    ``SpaceSlabs.advect`` on each y-slab (its halo through ``SlabHalo``,
    its offset through ``AdvectWindow``'s origin) against ``advect`` on
    the whole volume: the output and the velocity gradient bitwise, the
    field gradient, its halo rows' gradients returned to their owners,
    within SLAB_TOL (bitwise on the rows that take nothing from another
    slab); K1-K3b one launch per slab each. (2) Inside a 1-rank NCCL
    group: ``stylize_frame_spatial`` on ``spatial_mesh(1)`` over frame 0
    (W = 1, 3 octaves x 5 iterations) and the velocity parameterization
    (2 x 3) bitwise ``GridStyler.stylize_frame``, timed (s/iter, peak
    memory beside ``persistent_state_bytes``), their K1-K3 launches read;
    the engine on a (1, 1, 1) mesh bitwise the (1, 1) mesh's over 2
    frames (one code path: both meshes are one slab). Two ranks on one
    card are refused by NCCL, so the gathers and the exchange between
    ranks run only on gloo in the CPU tests. Returns the launches of the
    spatial runs."""
    import torch
    import torch.distributed as dist

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.parallel import (
        ParallelSequenceStyler, make_mesh, persistent_state_bytes,
        spatial_mesh, stylize_frame_spatial)
    from nfs_tpu_torch.styler.grid import GridStyler

    slabs = _slab_checks(card)

    cfg = _northstar_cfg(**{"optim.iters": 5})
    vcfg = _northstar_cfg(**{"optim.parameterization": "velocity",
                             "optim.octave_n": 2, "optim.iters": 3})
    style = np.random.default_rng(4).random((256, 256, 3),
                                            dtype=np.float32)
    rng = np.random.default_rng(5)
    ds = np.stack([_plume_density(SHAPE, t, rng) for t in range(2)])
    vs = np.stack([_swirl_velocity(SHAPE, t) for t in range(2)])
    vels = np.stack([vs[0], vs[0]])     # frame 0's W = 1 context
    runs, launches = {}, {}
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = spatial_mesh(1)
        for name, c, kw in (("density", cfg, {"vels": vels}),
                            ("velocity", vcfg, {})):
            styler = GridStyler(c, style_image=style, device="cuda")
            n_iter = c.optim.octave_n * c.optim.iters
            styler.stylize_frame(ds[0], **kw)               # warm-up
            out = {}
            for mode in ("unsharded", "spatial"):
                ak.reset_launches()
                torch.cuda.reset_peak_memory_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "spatial":
                    d, p, info = stylize_frame_spatial(styler, ds[0], mesh,
                                                       **kw)
                else:
                    d, p, info = styler.stylize_frame(ds[0], **kw)
                torch.cuda.synchronize()
                out[mode] = (d, p, (time.perf_counter() - t0) / n_iter,
                             torch.cuda.max_memory_allocated() / 2 ** 30)
                if mode == "spatial":
                    launches[name] = dict(ak.LAUNCHES)
            (d0, p0, s0, m0), (d1, p1, s1, m1) = (out["unsharded"],
                                                  out["spatial"])
            if not (torch.equal(d0, d1) and torch.equal(p0, p1)):
                raise AssertionError(
                    f"{name}: stylize_frame_spatial on spatial_mesh(1) "
                    f"differs from stylize_frame: "
                    f"{float((d0 - d1).abs().max())}")
            if not (torch.isfinite(d1).all() and float(d1.min()) >= 0.0):
                raise AssertionError(f"{name}: spatial output")
            runs[name] = {"s_per_iter": s1, "unsharded_s_per_iter": s0,
                          "peak_gib": m1, "unsharded_peak_gib": m0,
                          "persistent_state_gib": persistent_state_bytes(
                              SHAPE, c.optim.parameterization) / 2 ** 30,
                          "launches": launches[name],
                          "collectives": info["collectives"],
                          "bitwise_unsharded": True}
        if not (launches["density"]["fwd"] and launches["density"][
                "bwd_field"] and launches["velocity"]["bwd_vel"]):
            raise AssertionError(f"spatial runs launched {launches}")
        # the engine on a space axis of one: the same one slab as (1, 1)
        ecfg = _northstar_cfg(**{"optim.iters": 5})
        engine_out = []
        for m in ((1, 1), (1, 1, 1)):
            styler = GridStyler(ecfg, style_image=style, device="cuda")
            d, p, _ = ParallelSequenceStyler(styler, make_mesh(*m)).stylize(
                ds, vs)
            torch.cuda.synchronize()
            engine_out.append((d, p))
        if not (torch.equal(engine_out[0][0], engine_out[1][0])
                and torch.equal(engine_out[0][1], engine_out[1][1])):
            raise AssertionError("the (1, 1, 1) engine differs from the "
                                 "(1, 1) one")
    finally:
        dist.destroy_process_group()
    emit({"phase": "spatial", "shape": list(SHAPE), "slabs": slabs,
          "tol": SLAB_TOL, "runs": runs, "engine_1_1_1_bitwise": True,
          "reduced": "one card: the slabs of 2 and 4 ranks run in one "
                     "process, the styler and engine on a 1-rank NCCL "
                     "group; 5 iterations per octave (config #3: 20)",
          "card": card})
    return launches


def _keyframe_reference_run(dev: str, grid, color: bool):
    """The keyframe engine at a small size on one device: 3 frames
    (keyframes 0 and 2) of 1 500 particles, position + density (+ colour
    in 3D: the 5-channel binned pass), 2 octaves x 3 iterations, float32
    features, one view. Returns (losses, [(x, dens[, color])])."""
    import torch

    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.parallel import ParallelKeyframeStyler, make_mesh
    from nfs_tpu_torch.styler.particle import ParticleStyler

    rng = np.random.default_rng(16)
    n = 1500
    x0 = (rng.random((n, len(grid))) * (np.array(grid) - 4) + 2).astype(
        np.float32)
    col = rng.random((n, 3), dtype=np.float32) if color else None
    frames = [ParticleSet(x=x0 + np.float32(0.1 * t),
                          dens=np.ones(n, np.float32), color=col)
              for t in range(3)]
    cfg = _northstar_cfg(**{
        "render.render_size": (32, 32), "render.min_render_size": 16,
        "render.n_views": 2, "render.view_pool": 1, "render.transmit": 0.5,
        "loss.style_layers": ("relu1_1", "relu2_1"),
        "loss.style_layer_weights": (1.0, 1.0), "loss.w_style": 1000.0,
        "loss.features_dtype": "float32", "optim.octave_n": 2,
        "optim.octave_scale": 2.0, "optim.iters": 3, "optim.lr": 0.05,
        "particle.optimize_density": True, "particle.optimize_color": color,
        "particle.keyframe_stride": 2})
    engine = ParallelKeyframeStyler(ParticleStyler(
        cfg, grid_shape=grid, style_image=rng.random(
            (32, 32, 3), dtype=np.float32), device=dev), make_mesh(1, 1))
    outs = [tuple(a.cpu().numpy() for a in (p.x, p.dens)
                  + ((p.color,) if color else ()))
            for _, p in engine.stylize_keyframes(frames)]
    losses = torch.cat([torch.cat(i["octave_losses"]).cpu() for _, i in
                        sorted(engine.last_keyframe_infos.items())])
    return losses.numpy(), outs


def _profile_keyframes(card: str, styler, psets, n_keyframes: int):
    """The keyframe engine's five keyframes once more under
    torch.profiler: kernel time per joint iteration (all three octaves,
    every keyframe) by category and the idle share of the traced run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nfs_tpu_torch.parallel import ParallelKeyframeStyler, make_mesh

    oc = styler.cfg.optim
    engine = ParallelKeyframeStyler(styler, make_mesh(1, 1))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in engine.stylize_keyframes(psets):
            pass
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    emit(dict({"phase": "profile", "slice": "keyframes",
               "keyframes": n_keyframes, "grid": list(P_GRID),
               "particles": P_COUNT},
              **_trace_summary(prof, oc.octave_n * oc.iters, traced_wall),
              card=card))


def phase_keyframes(card: str, profile: bool = False):
    """The keyframe-parallel LNST engine (``ParallelKeyframeStyler``) on a
    (1, 1) mesh at the full particles_3d width (``_particle_cfg``: 200
    000 particles, 96x64x96, 9 views at 256^2, 3 octaves x 20,
    position + density, bf16 features) over 41 frames of the particle
    phase's scene, keyframes 0, 10, 20, 30 and 40 in one program: a run
    over 11 frames (2 keyframes; warm-up, and its peak memory for the GiB
    per keyframe), the timed 41-frame run (s per keyframe, s per output
    frame, peak memory, K4/K5 launches), the same five keyframes as five
    independent ``ParticleStyler.stylize_frame`` calls with the engine's
    generators and the bin-capacity plan cleared between them (timed;
    the engine's particles must lie within rtol 4e-3 and atol 4e-4 of
    theirs, positions compared as offsets from the input frame, and its
    K4 and K5 launches must equal one of them: one
    launch serves all five keyframes), the engine inside a 1-rank NCCL
    group (bitwise the run without one), and small 3D colour and 2D
    keyframe runs held against the CPU port; with ``profile``, the
    41-frame run once more under torch.profiler. Returns the K4/K5
    launches of the 41-frame run."""
    import torch
    import torch.distributed as dist

    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.ops import binsplat_kernels as bk
    from nfs_tpu_torch.parallel import ParallelKeyframeStyler, make_mesh
    from nfs_tpu_torch.parallel.particles import keyframe_generator
    from nfs_tpu_torch.styler.particle import (
        ParticleStyler, interp_sequence, keyframe_indices)

    T, T2 = 41, 11
    cfg = _particle_cfg()
    pc = cfg.particle
    xs = _particle_frames(T)
    dens = np.ones(P_COUNT, np.float32)
    psets = [ParticleSet(x=x, dens=dens) for x in xs]
    style = np.random.default_rng(1).random((256, 256, 3),
                                            dtype=np.float32)
    styler = ParticleStyler(cfg, grid_shape=P_GRID, style_image=style,
                            device="cuda")
    keyframes = keyframe_indices(T, pc.keyframe_stride)

    def run(frames, mesh=None):
        engine = ParallelKeyframeStyler(styler, mesh or make_mesh(1, 1))
        bk.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = [(t, p.x.cpu().numpy(), p.dens.cpu().numpy())
                for t, p in engine.stylize_keyframes(frames)]
        wall = time.perf_counter() - t0
        return (wall, outs, dict(bk.LAUNCHES),
                torch.cuda.max_memory_allocated() / 2 ** 30, engine)

    wall2, _, _, peak2, _ = run(psets[:T2])        # 2 keyframes, warm-up
    wall, outs, launches, peak, engine = run(psets)
    infos = engine.last_keyframe_infos
    if [t for t, _, _ in outs] != list(range(T)) or sorted(infos) != \
            keyframes:
        raise AssertionError(f"engine frames {[o[0] for o in outs]}, "
                             f"keyframes {sorted(infos)}")
    for t, x, d in outs:
        if not (x.shape == (P_COUNT, 3) and np.isfinite(x).all()
                and np.isfinite(d).all()
                and float(np.abs(x - xs[t]).max()) <= pc.max_offset):
            raise AssertionError(f"engine frame {t}: bad output")
    # each iteration draws its own views, so a single loss is noisy: the
    # finest octave's first and last quarters, over all keyframes
    finest = np.stack([i["octave_losses"][-1].cpu().numpy()
                       for i in infos.values()])
    q = max(1, finest.shape[1] // 4)
    if not finest[:, -q:].mean() < finest[:, :q].mean():
        raise AssertionError(f"the finest octave's loss did not drop: "
                             f"{finest}")

    # the five keyframes as independent single-keyframe runs
    params, single_s, single_launches = {}, [], []
    for kf in keyframes:
        styler._k_cache.clear()
        bk.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, params[kf], _ = styler.stylize_frame(
            psets[kf], generator=keyframe_generator(cfg.seed, kf))
        torch.cuda.synchronize()
        single_s.append(time.perf_counter() - t0)
        single_launches.append(dict(bk.LAUNCHES))
    if launches != single_launches[0] or launches["fwd"] <= 0 \
            or launches["bwd"] <= 0:
        raise AssertionError(f"the engine's K4/K5 launches {launches} for "
                             f"{len(keyframes)} keyframes are not one "
                             f"keyframe's {single_launches[0]}")
    ref = {t: (p.x.cpu().numpy(), p.dens.cpu().numpy())
           for t, p in interp_sequence(
               psets, keyframes, params, float(pc.max_offset),
               apply_fn=styler.apply_param)}
    # positions are compared as offsets from the input frame: absolute
    # positions near 90 cells would let rtol hide a wrong offset
    err = {"dx_max_abs": 0.0, "dens_max_abs": 0.0, "dx_excess": 0.0,
           "dens_excess": 0.0}
    for t, x, d in outs:
        for k, got, want in (("dx", x - xs[t], ref[t][0] - xs[t]),
                             ("dens", d, ref[t][1])):
            diff = np.abs(got - want)
            err[k + "_max_abs"] = max(err[k + "_max_abs"], float(diff.max()))
            # > 0 where assert_allclose(rtol=4e-3, atol=4e-4) would fail
            err[k + "_excess"] = max(err[k + "_excess"], float(
                (diff - 4e-4 - 4e-3 * np.abs(want)).max()))
    if not (err["dx_excess"] <= 0.0 and err["dens_excess"] <= 0.0):
        raise AssertionError(f"the engine departs from the independent "
                             f"keyframes: {err}")

    # a 1-rank NCCL group: the gather runs on the card
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        _, outs_nccl, _, _, eng_nccl = run(psets, make_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    if not all(np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
               for a, b in zip(outs_nccl, outs)):
        raise AssertionError("the engine in a 1-rank NCCL group differs "
                             "from the run without one")
    if eng_nccl.last_collectives["all_gather"] != 1:
        raise AssertionError(f"NCCL run collectives "
                             f"{eng_nccl.last_collectives}")

    # small colour (3D) and 2D keyframe batches against the CPU port
    reference = {}
    for grid, color in (((16, 12, 16), True), ((24, 18), False)):
        (lc, oc_), (lg, og) = (_keyframe_reference_run(dev, grid, color)
                               for dev in ("cpu", "cuda"))
        e = {"loss_rel": float(np.max(np.abs(lg - lc) / np.abs(lc)))}
        for i, k in enumerate(("x", "dens", "color")[:len(og[0])]):
            e[k + "_max_abs"] = max(float(np.abs(g[i] - c[i]).max())
                                    for g, c in zip(og, oc_))
        reference["x".join(map(str, grid))] = e
        if not (all(np.isfinite(a).all() for o in og for a in o)
                and e["loss_rel"] <= 1e-4
                and max(v for k, v in e.items() if k != "loss_rel")
                <= 1e-3):
            raise AssertionError(f"keyframe engine on the card departs from "
                                 f"the CPU: {grid} {e}")

    B = len(keyframes)
    emit({"phase": "keyframes", "frames": T, "keyframes": keyframes,
          "particles": P_COUNT, "grid": list(P_GRID), "mesh": [1, 1],
          "reduced": "nothing of the particles_3d bench widths: random VGG "
                     "weights and style image (no downloads)",
          "engine_wall_s": wall, "s_per_keyframe": wall / B,
          "s_per_output_frame": wall / T,
          "independent_keyframe_s": single_s,
          "independent_s_per_keyframe": sum(single_s) / B,
          "peak_gib": peak, "peak_gib_2_keyframes": peak2,
          "gib_per_keyframe": (peak - peak2) / (B - 2),
          "wall_2_keyframes_s": wall2,
          "launches": launches,
          "launches_independent_keyframes": single_launches,
          "launches_per_finest_iter": {
              k: v / cfg.optim.iters for k, v in launches.items()},
          "octave_overflow": {kf: i["octave_overflow"]
                              for kf, i in infos.items()},
          "finest_loss_quarters": [float(finest[:, :q].mean()),
                                   float(finest[:, -q:].mean())],
          "vs_independent": err, "tol": {"rtol": 4e-3, "atol": 4e-4},
          "nccl_1_rank_bitwise": True,
          "nccl_collectives": eng_nccl.last_collectives,
          "reference_vs_cpu": reference,
          "reference_tol": {"loss_rel": 1e-4, "max_abs": 1e-3},
          "card": card})
    if profile:
        _profile_keyframes(card, styler, psets, B)
    return launches


def _serve_cfg():
    """The density slice's config as a serve job's overrides (JSON)."""
    return {"render.render_size": [256, 256], "render.n_views": 9,
            "render.view_pool": 32, "render.transmit": 0.01,
            "loss.style_layers": ["relu1_1", "relu2_1", "relu3_1",
                                  "relu4_1"],
            "loss.style_layer_weights": [1.0, 1.0, 1.0, 1.0],
            "loss.features_dtype": "bfloat16", "optim.octave_n": 3,
            "optim.octave_scale": 1.8, "optim.lr": 0.02, "optim.iters": 5,
            "optim.window": 1}


def _serve_parallel_job(data_dir, out_dir, style):
    """Job D: a "parallel" grid job over 2 frames at small widths (64^2
    renders, 2 style layers, float32 features, style weight 1000 so that
    the random VGG's gradients stay above Adam's eps), small enough to
    run on the CPU too."""
    return {"mode": "grid", "data_dir": data_dir, "frames": [0, 1],
            "out_dir": out_dir, "style_target": style, "parallel": True,
            "config": {"render.render_size": [64, 64], "render.n_views": 9,
                       "render.view_pool": 32, "render.transmit": 0.5,
                       "loss.style_layers": ["relu1_1", "relu2_1"],
                       "loss.style_layer_weights": [1.0, 1.0],
                       "loss.w_style": 1000.0, "optim.octave_n": 2,
                       "optim.octave_scale": 2.0, "optim.lr": 0.02,
                       "optim.iters": 3, "optim.window": 1}}


def _serve_keyframes_job(data_dir, out_dir, style):
    """Job D2: a "parallel" particle job over 3 frames (keyframes 0 and
    2) of 1 500 particles on a 16^3 grid at small widths (64^2 renders, 2
    style layers, float32 features, style weight 1000, one view), small
    enough to run on the CPU too."""
    return {"mode": "particle", "data_dir": data_dir, "frames": [0, 1, 2],
            "out_dir": out_dir, "style_target": style, "parallel": True,
            "grid_shape": [16, 16, 16],
            "config": {"render.render_size": [64, 64], "render.n_views": 2,
                       "render.view_pool": 1, "render.transmit": 0.5,
                       "loss.style_layers": ["relu1_1", "relu2_1"],
                       "loss.style_layer_weights": [1.0, 1.0],
                       "loss.w_style": 1000.0, "optim.octave_n": 2,
                       "optim.octave_scale": 2.0, "optim.lr": 0.05,
                       "optim.iters": 3,
                       "particle.optimize_density": True,
                       "particle.keyframe_stride": 2}}


def _serve_particle_cfg():
    """The particles_3d bench config (``_particle_cfg``) at 4 iterations
    per octave as a serve job's overrides (JSON)."""
    return {"render.render_size": [256, 256], "render.n_views": 9,
            "render.transmit": 0.05, "loss.features_dtype": "bfloat16",
            "optim.octave_n": 3, "optim.iters": 4,
            "particle.optimize_position": True,
            "particle.optimize_density": True,
            "particle.keyframe_stride": 10}


def _particle_gap(dir_a, dir_b, n: int) -> float:
    """Largest |difference| of the positions and densities of frames 0..n-1
    written to two output directories."""
    from nfs_tpu_torch.io.npz import FrameStore

    gap = 0.0
    for t in range(n):
        a, b = (FrameStore(d).load_particles(t) for d in (dir_a, dir_b))
        gap = max(gap, *(float(np.abs(a[k] - b[k]).max())
                         for k in ("x", "dens")))
    return gap


def _d2_repeat(serve_mod, job, served_dir, root) -> dict:
    """Whether the card repeats job D2 bit for bit: the job twice more
    through one card worker of this process in each of three modes,
    ``default``, ``cudnn_deterministic`` (``torch.backends.cudnn.
    deterministic``) and ``deterministic``
    (``torch.use_deterministic_algorithms(True, warn_only=True)``), with
    the two runs' gap, the first run's gap to the served D2 and the ops
    PyTorch warned of as having no deterministic implementation. A
    report, not a check."""
    import warnings

    import torch

    worker = serve_mod.StylizeWorker("cuda")
    report = {}
    for mode in ("default", "cudnn_deterministic", "deterministic"):
        dirs = [os.path.join(root, f"d2_{mode}_{r}") for r in range(2)]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.backends.cudnn.deterministic = mode != "default"
            torch.use_deterministic_algorithms(mode == "deterministic",
                                               warn_only=True)
            try:
                for d in dirs:
                    if worker.run_job(dict(job, out_dir=d))["status"] != "ok":
                        raise AssertionError(f"job d2 again ({mode})")
            finally:
                torch.use_deterministic_algorithms(False)
                torch.backends.cudnn.deterministic = False
        report[mode] = {
            "repeat_max_abs": _particle_gap(dirs[0], dirs[1], 3),
            "vs_served_max_abs": _particle_gap(dirs[0], served_dir, 3),
            "warned": sorted({str(w.message)[:120] for w in caught
                              if "determinis" in str(w.message)})}
    return report


def phase_serve(card: str, root: str, smoke_dir: str):
    """The stylization service in-process, ``serve(spool, max_jobs=6)``,
    over the scene phase's smoke3d frames at the density slice's config
    (job overrides; 5 iterations per octave, W=1): (A) a grid job over
    frames 0-2; (B) the same job into another out_dir, which must hit
    the styler and frame caches and equal A within 1e-3; (B2) B again
    under ``utils.profiling.trace``, whose Chrome trace must hold
    advect_fwd_kernel; (C) a particle job at the particles_3d width (200
    000 particles, 96x64x96, 3 octaves x 4 iterations, keyframes 0 and
    1); (D) a "parallel" grid job (the joint engine on the service's
    (1, 1) mesh) over 2 frames of a 24x16x24 smoke3d scene at small
    widths (float32 features), which must succeed and match the same job
    through a CPU worker within 1e-3; (D2) a "parallel" particle job (the
    keyframe-parallel engine on that mesh) over 3 frames of 1 500
    particles at small widths, which must succeed and match the same job
    through a CPU worker within 1e-3; then the stop marker. K1 and K2
    must launch in A and D, K4 and K5 in C and D2 (counts reset before
    each job and read after it). D2 then runs six times more on a card
    worker, whose bitwise repeatability is reported (``_d2_repeat``).
    Returns (A's out_dir, C's out_dir, the
    style image path)."""
    import torch

    from nfs_tpu_torch.cli import scene
    from nfs_tpu_torch.cli import serve as serve_mod
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops import binsplat_kernels as bk
    from nfs_tpu_torch.utils.profiling import trace

    spool = os.path.join(root, "spool")
    style = os.path.join(root, "serve_style.npy")
    size = tuple(_serve_cfg()["render.render_size"])
    np.save(style, np.random.default_rng(1).random(size + (3,),
                                                   dtype=np.float32))
    pdir = os.path.join(root, "particles")
    store = FrameStore(pdir)
    for t, x in enumerate(_particle_frames(2)):
        store.save_particles(t, x=x, dens=np.ones(P_COUNT, np.float32))
    out = {k: os.path.join(root, "served", k)
           for k in ("a", "b", "b2", "c", "d", "d2", "d_cpu", "d2_cpu")}
    small_pdir = os.path.join(root, "particles_small")
    rng = np.random.default_rng(17)
    x0 = (rng.random((1500, 3)) * 12 + 2).astype(np.float32)
    for t in range(3):
        FrameStore(small_pdir).save_particles(
            t, x=x0 + np.float32(0.1 * t), dens=np.ones(1500, np.float32))
    small_dir = os.path.join(root, "smoke3d_small")
    style_d = os.path.join(root, "serve_style_64.npy")
    np.save(style_d, np.random.default_rng(1).random((64, 64, 3),
                                                      dtype=np.float32))
    with contextlib.redirect_stdout(io.StringIO()):
        scene.main(["--scene", "smoke3d", "--out", small_dir, "--res",
                    "24", "16", "24", "--frames", "2"])
    grid_job = {"mode": "grid", "data_dir": smoke_dir, "frames": [0, 1, 2],
                "style_target": style, "config": _serve_cfg()}
    particle_job = {"mode": "particle", "data_dir": pdir, "frames": [0, 1],
                    "style_target": style, "grid_shape": list(P_GRID),
                    "config": _serve_particle_cfg()}
    jobs = {
        "a": dict(grid_job, out_dir=out["a"]),
        "b": dict(grid_job, out_dir=out["b"]),
        "b2": dict(grid_job, out_dir=out["b2"]),
        "c": dict(particle_job, out_dir=out["c"]),
        "d": _serve_parallel_job(small_dir, out["d"], style_d),
        "d2": _serve_keyframes_job(small_pdir, out["d2"], style_d),
    }
    for name, job in jobs.items():
        serve_mod.submit_job(spool, job, name=name)

    trace_dir = os.path.join(root, "serve_trace")
    per_job = {}
    run_job = serve_mod.StylizeWorker.run_job

    def counted(self, job):
        name = os.path.basename(job["out_dir"])
        ak.reset_launches()
        bk.reset_launches()
        torch.cuda.synchronize()
        try:
            if name == "b2":
                with trace(trace_dir):
                    return run_job(self, job)
            return run_job(self, job)
        finally:
            torch.cuda.synchronize()
            per_job[name] = {"advect": dict(ak.LAUNCHES),
                             "binsplat": dict(bk.LAUNCHES)}

    serve_mod.StylizeWorker.run_job = counted
    try:
        t0 = time.perf_counter()
        stats = serve_mod.serve(spool, poll_s=0.01, max_jobs=len(jobs))
        serve_s = time.perf_counter() - t0
    finally:
        serve_mod.StylizeWorker.run_job = run_job
    open(os.path.join(spool, "stop"), "w").close()
    stopped = serve_mod.serve(spool, poll_s=0.01)

    results = {}
    for name in jobs:
        with open(os.path.join(spool, "done", f"{name}.json")) as f:
            results[name] = json.load(f)
    for name in jobs:
        if results[name]["status"] != "ok":
            raise AssertionError(f"job {name}: {results[name]}")
    # jobs D and D2 again through a CPU worker: the port's plain twins
    cpu_worker = serve_mod.StylizeWorker("cpu")
    for name in ("d", "d2"):
        cpu_job = dict(jobs[name], out_dir=out[name + "_cpu"])
        if cpu_worker.run_job(cpu_job)["status"] != "ok":
            raise AssertionError(f"job {name} on the CPU")
    d_vs_cpu = max(float(np.abs(
        FrameStore(out["d"]).load_density(t)
        - FrameStore(out["d_cpu"]).load_density(t)).max()) for t in range(2))
    if not d_vs_cpu <= 1e-3:
        raise AssertionError(f"parallel job D departs from the CPU port: "
                             f"{d_vs_cpu}")
    for t in range(3):
        got = FrameStore(out["d2"]).load_particles(t)
        if not (got["x"].shape == (1500, 3) and np.isfinite(got["x"]).all()):
            raise AssertionError(f"job d2 frame {t}: bad output")
    d2_vs_cpu = _particle_gap(out["d2"], out["d2_cpu"], 3)
    if not d2_vs_cpu <= 1e-3:
        raise AssertionError(f"parallel particle job D2 departs from the "
                             f"CPU port: {d2_vs_cpu}")
    d2_repeat = _d2_repeat(serve_mod, jobs["d2"], out["d2"],
                           os.path.join(root, "served"))
    hb = [f for f in os.listdir(spool) if f.startswith("worker_")]
    with open(os.path.join(spool, hb[0])) as f:
        beat = json.load(f)
    if beat["status"] != "stopped" or stopped["jobs"] != 0:
        raise AssertionError(f"heartbeat {beat}, after stop {stopped}")
    if not (stats["styler_cache_hits"] >= 1
            and stats["frame_cache_hits"] >= 1 and stats["jobs"] == 6
            and stats["errors"] == 0):
        raise AssertionError(f"worker stats {stats}")
    a_l, c_l, d_l = per_job["a"], per_job["c"], per_job["d"]
    d2_l = per_job["d2"]
    if not (a_l["advect"]["fwd"] > 0 and a_l["advect"]["bwd_field"] > 0
            and d_l["advect"]["fwd"] > 0 and d_l["advect"]["bwd_field"] > 0
            and c_l["binsplat"]["fwd"] > 0 and c_l["binsplat"]["bwd"] > 0
            and d2_l["binsplat"]["fwd"] > 0
            and d2_l["binsplat"]["bwd"] > 0):
        raise AssertionError(f"launches per job {per_job}")

    grid_a, grid_b = FrameStore(out["a"]), FrameStore(out["b"])
    b_vs_a = 0.0
    for t in range(3):
        da, db = grid_a.load_density(t), grid_b.load_density(t)
        if not (da.shape == SHAPE and np.isfinite(da).all()):
            raise AssertionError(f"job a frame {t}: bad output")
        b_vs_a = max(b_vs_a, float(np.abs(da - db).max()))
    if not b_vs_a <= 1e-3:
        raise AssertionError(f"job b departs from job a: {b_vs_a}")
    for t in range(2):
        p = FrameStore(out["c"]).load_particles(t)
        if not (p["x"].shape == (P_COUNT, 3) and np.isfinite(p["x"]).all()
                and np.isfinite(p["dens"]).all()):
            raise AssertionError(f"job c frame {t}: bad output")
    traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    k1_events = sum(1 for e in events
                    if "advect_fwd_kernel" in str(e.get("name", "")))
    if not k1_events:
        raise AssertionError("the trace of job b2 holds no "
                             "advect_fwd_kernel event")
    emit({"phase": "serve", "shape": list(SHAPE), "frames": 3,
          "reduced": "optim.iters 5 per octave (config #3: 20); particle "
                     "job 4 (bench: 20); random VGG weights and style",
          "wall_s": {k: results[k].get("wall_s") for k in jobs},
          "first_vs_cached_wall_s": [results["a"]["wall_s"],
                                     results["b"]["wall_s"]],
          "serve_s": serve_s, "stats": stats, "b_vs_a_max_abs": b_vs_a,
          "tol": {"b_vs_a_max_abs": 1e-3}, "launches": per_job,
          "trace_events": len(events), "trace_k1_events": k1_events,
          "parallel_d_vs_cpu_max_abs": d_vs_cpu,
          "parallel_particle_d2_vs_cpu_max_abs": d2_vs_cpu,
          "d2_repeat_on_card": d2_repeat,
          "tol_vs_cpu": 1e-3,
          "heartbeat": beat["status"],
          "card": card})
    return out["a"], out["c"], style


def _image_files(out_dir, n: int):
    """The render CLI's frames: ``.png`` with PIL, ``.png.npy`` without."""
    imgs = []
    for t in range(n):
        path = os.path.join(out_dir, f"frame_{t:04d}.png")
        if os.path.exists(path + ".npy"):
            imgs.append(np.load(path + ".npy"))
        else:
            from PIL import Image

            with Image.open(path) as f:
                imgs.append(np.asarray(f))
    return imgs


def phase_render_quality(card: str, root: str, smoke_dir: str, a_dir: str,
                         c_dir: str, style_path: str, remat_losses,
                         density_s_per_iter: float):
    """``cli.render`` over the serve phase's grid output (3 frames, grey
    and 'fire') and its particle output (splatted onto 96x64x96): every
    image written, finite and not constant. Then the quality metrics of
    ``eval``: temporal coherence of the raw smoke3d frames 0-2 and of job
    A's stylized frames against the sim velocities (K1, max_disp 2), the
    coherence gate, the stylization strength of frame 0, the Gram
    distance to the style of 9 views of the stylized and of the raw frame
    0, the Gram convergence of the remat phase's losses; and the density
    slice's analytic FLOPs per iteration and its MFU against the H100's
    dense bf16 peak. Gates nothing beyond finiteness and the gate's own
    output."""
    import torch

    from nfs_tpu_torch.cli.render import main as render
    from nfs_tpu_torch.eval import (
        coherence_gate, gram_convergence, gram_distance,
        stylization_strength, temporal_coherence)
    from nfs_tpu_torch.features.losses import style_gram_targets
    from nfs_tpu_torch.features.vgg import init_vgg_params
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.render.camera import poisson_view_pool
    from nfs_tpu_torch.render.raymarch import render_views
    from nfs_tpu_torch.utils.flops import (
        H100_SXM_PEAK_BF16, mfu, styler_step_flops)

    renders = {}
    for label, argv, src, n in (
            ("grey", [], a_dir, 3),
            ("fire", ["--transfer_fn", "fire"], a_dir, 3),
            ("particle", ["--mode", "particle", "--grid_shape",
                          *map(str, P_GRID)], c_dir, 2)):
        dst = os.path.join(root, "render", label)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            render(["--data_dir", src, "--num_frames", str(n), "--out", dst]
                   + argv)
        imgs = _image_files(dst, n)
        for img in imgs:
            if not (np.isfinite(img).all() and img.max() > img.min()):
                raise AssertionError(f"render {label}: a bad image")
        renders[label] = {"frames": n, "shape": list(imgs[0].shape),
                          "wall_s": time.perf_counter() - t0}

    raw, out = FrameStore(smoke_dir), FrameStore(a_dir)
    dev = torch.device("cuda")
    raw_d = np.stack([raw.load_density(t) for t in range(3)])
    vels = np.stack([raw.load_velocity(t) for t in range(3)])
    sty_d = np.stack([out.load_density(t) for t in range(3)])
    ak.reset_launches()
    sim = temporal_coherence(torch.from_numpy(raw_d).to(dev),
                             torch.from_numpy(vels).to(dev), max_disp=2.0)
    stylized = temporal_coherence(torch.from_numpy(sty_d).to(dev),
                                  torch.from_numpy(vels).to(dev),
                                  max_disp=2.0)
    k1 = ak.LAUNCHES["fwd"]
    if k1 != 4:
        raise AssertionError(f"temporal_coherence launched K1 {k1} times")
    gate = coherence_gate(stylized["ratio"], sim["ratio"])
    strength = stylization_strength(torch.from_numpy(sty_d[0]).to(dev),
                                    torch.from_numpy(raw_d[0]).to(dev))

    cfg = _northstar_cfg()
    rc, lc = cfg.render, cfg.loss
    vgg = init_vgg_params(cfg.seed, device=dev)
    style = torch.from_numpy(np.load(style_path)).to(dev)
    with torch.no_grad():
        targets = style_gram_targets(vgg, style, lc.style_layers)
        views = torch.from_numpy(poisson_view_pool(
            rc.view_pool, rc.n_views, (rc.theta0, rc.theta1),
            (rc.phi0, rc.phi1), seed=cfg.seed)[0]).to(dev)
        gram = {}
        for label, d in (("stylized", sty_d[0]), ("raw", raw_d[0])):
            imgs = render_views(torch.from_numpy(d).to(dev), views[:, 0],
                                views[:, 1], transmit=rc.transmit,
                                out_size=rc.render_size)
            gram[label] = gram_distance(vgg, imgs, targets, lc.style_layers,
                                        dtype=torch.bfloat16)
    convergence = gram_convergence([remat_losses])
    flops = styler_step_flops(SHAPE, rc.render_size, rc.n_views,
                              lc.style_layers,
                              n_window_renders=2 * cfg.optim.window + 1)
    numbers = [sim["ratio"], stylized["ratio"], strength["rel_change"],
               gram["stylized"], gram["raw"],
               convergence["overall_drop_pct"]]
    if not all(math.isfinite(x) for x in numbers):
        raise AssertionError(f"non-finite quality metrics {numbers}")
    emit({"phase": "render_quality", "renders": renders,
          "temporal_coherence": {"sim": sim, "stylized": stylized,
                                 "gate_pass": gate, "k1_launches": k1},
          "stylization_strength": strength,
          "gram_distance_9_views": gram,
          "gram_convergence_remat": convergence,
          "density_slice_flops_per_iter": flops,
          "density_slice_s_per_iter": density_s_per_iter,
          "mfu_vs_h100_bf16": mfu(flops / density_s_per_iter),
          "peak": H100_SXM_PEAK_BF16, "card": card})


def main(argv=None) -> int:
    args = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one GPU")
    args.add_argument("--profile", action="store_true",
                      help="also profile the density slice at config #3's "
                           "20 iterations per octave, keyframe 10 of the "
                           "particle phase and the keyframe engine's five "
                           "keyframes")
    args = args.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script needs an NVIDIA GPU")
    # the port must come from this checkout: fail before printing anything
    # when the script stands alone
    import nfs_tpu_torch  # noqa: F401

    started = time.perf_counter()
    kind, card = phase_device()

    phase_build()
    records = phase_kernels(card)
    far_record = phase_far_kernels(card)
    batched = phase_batched_kernels(card)
    octaves = _octave_ks()
    bin_records = phase_bin_kernels(card, octaves[-1][1], octaves[0])
    bin_batched = phase_bin_kernels_batched(card, octaves[-1][1])
    phase_reference(card)
    phase_reference_particle(card)
    with tempfile.TemporaryDirectory(prefix="nfs_chip_smoke_") as tmp:
        density_s_per_iter = phase_density(card, tmp)
    split = phase_velocity(card)
    # launches of the grid main path (density + velocity runs): the
    # counters were reset just before the density run
    from nfs_tpu_torch.ops import advect_kernels as ak

    launches = dict(ak.LAUNCHES)
    # K3b's path, where both gradients are needed: the chain of the A/B,
    # which resets and reads its own counters
    launches["bwd_fused"] = phase_fused_bwd_ab(card)
    phase_velocity(card, fused_bwd=True, split=split)
    # the untiled pull's path: the density slice at max_disp 9
    launches["bwd_field_untiled"] = phase_far(card)
    # the particle path resets and reads its own counters
    bin_launches = phase_particle(card, args.profile)
    if args.profile:
        phase_profile(card)
    phase_2d(card)
    phase_transfer_gather(card)
    # the exact advection path launches no hand kernel (it checks so)
    phase_exact(card)
    remat_losses = phase_remat(card)
    with tempfile.TemporaryDirectory(prefix="nfs_chip_smoke_") as tmp:
        phase_color(card, tmp)
        smoke_dir = phase_scene(card, tmp)
        phase_northstar(card, tmp)
        phase_cli(card, tmp, smoke_dir)
        # the joint engine's path resets and reads its own counters
        par_launches, par_vel_launches = phase_parallel(card, tmp,
                                                        smoke_dir)
        # the keyframe engine's path resets and reads its own counters
        kf_launches = phase_keyframes(card, args.profile)
        # the spatial path resets and reads its own counters
        sp_launches = phase_spatial(card)
        phase_checkpoint(card, tmp, smoke_dir)
        a_dir, c_dir, style = phase_serve(card, tmp, smoke_dir)
        phase_render_quality(card, tmp, smoke_dir, a_dir, c_dir, style,
                             remat_losses, density_s_per_iter)
    for recs, keys, counts in ((records, KERNELS, launches),
                               ([far_record], (UNTILED,), launches),
                               (bin_records, BIN_KERNELS, bin_launches)):
        for rec, (key, _, _) in zip(recs, keys):
            rec["launches"] = counts[key]
            if rec["launches"] <= 0:
                raise AssertionError(f"{rec['name']} never launched")
            if not all(math.isfinite(rec[k]) for k in
                        ("max_abs_err", "ms", "plain_ms", "device_ms",
                         "host_us", "bound_ms")):
                raise AssertionError(f"bad numbers in {rec}")
    # the frame batch of each advection kernel, and its launches on the
    # joint engine's path (T = 8 density run; K3 from its velocity run)
    for rec, (key, _, _) in zip(records + [far_record],
                                KERNELS + (UNTILED,)):
        rec["batched_b4"] = batched[key]
        rec["parallel_launches"] = (par_vel_launches if key == "bwd_vel"
                                    else par_launches)[key]
        # launches of the spatial runs (density W = 1 and velocity)
        rec["spatial_launches"] = sum(l[key] for l in sp_launches.values())
        if key in ("fwd", "bwd_field", "bwd_vel") and \
                rec["spatial_launches"] <= 0:
            raise AssertionError(f"{rec['name']} never launched on the "
                                 f"spatial path")
    # the keyframe batch of K4 and K5, and their launches on the keyframe
    # engine's path (five keyframes in one program)
    for rec, (key, _, _) in zip(bin_records, BIN_KERNELS):
        rec["batched_b4"] = bin_batched[key]
        rec["keyframes_launches"] = kf_launches[key]
        if rec["keyframes_launches"] <= 0:
            raise AssertionError(f"{rec['name']} never launched on the "
                                 f"keyframe engine's path")
    emit({"phase": "total", "seconds": time.perf_counter() - started})
    emit({"kernels": records + [far_record] + bin_records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
