#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nfs_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line:

1. device  — needs ``torch.cuda.is_available()`` and the port
   (``nfs_tpu_torch``) beside the script; prints the card's name and the
   ``nvidia-smi`` name and power limit.
2. build   — compiles ``nfs_tpu_torch/csrc/advect.cu`` with nvcc for
   sm_90a into ``build/nfs_tpu_torch/`` and loads it.
3. kernels — K1-K3 against their plain PyTorch twins on the card at the
   main path's 112x64x112 shape (random, clamped, integer-valued and zero
   velocities; max_disp 2 and 1), and both timed (median of CUDA-event
   timed runs).
   reference — a small run of the slice on the GPU against the same run
   on the CPU (plain twins; the CPU port is held against the JAX package
   by the tests).
4. density — the grid styler's streaming sequence path at config #3
   widths with the window-transport loss (W=1): 3 frames of 112x64x112
   through ``FrameStore`` and ``GridStyler.stylize_sequence``.
5. velocity — the velocity parameterization (config #4), one frame, W=1.
6. profile (only with ``--profile``) — the density slice at config #3's
   20 iterations per octave: steady seconds per iteration and per frame,
   then two frames under ``torch.profiler`` for the device's kernel time
   per iteration by category and its idle share in that traced run.

Then one JSON line with every kernel's route, error, launches on the main
path and times, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises, so the exit code is non-zero and no result is printed.
Weights (VGG), style image and data are random, made from fixed seeds.
"""

from __future__ import annotations

import argparse
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
)
TOL = {"fwd": 1e-5, "bwd_field": 1e-4, "bwd_vel": 1e-4}


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
    from nfs_tpu_torch.ops import advect_kernels as ak

    t0 = time.perf_counter()
    so = ak.build_library()
    ak.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(so)})


def _kernel_inputs(case: str, max_disp: float, seed: int):
    """Seeded field, cotangent and displacement. 'random' velocities are
    normal with sigma = max_disp / 1.2816, so ~20% of the components
    exceed max_disp and get clamped."""
    rng = np.random.default_rng(seed)
    f = rng.random(SHAPE, dtype=np.float32)
    g = rng.standard_normal(SHAPE, dtype=np.float32)
    v = (max_disp / 1.2816) * rng.standard_normal(SHAPE + (3,),
                                                  dtype=np.float32)
    if case == "integer":
        v = np.round(v)
    elif case == "zero":
        v = np.zeros_like(v)
    return f, g, v


def _median_ms(fn, runs: int = 30) -> float:
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


def phase_kernels(card: str):
    """K1-K3 against the plain twins on the card. Returns the per-kernel
    records of the final JSON line (launches are filled in later)."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak

    dev = torch.device("cuda", 0)
    pairs = {
        "fwd": (lambda f, g, v, d: ak.advect_fwd(f, v, d),
                lambda f, g, v, d: ak.advect_fwd_plain(f, v, d)),
        "bwd_field": (lambda f, g, v, d: ak.advect_bwd_field(v, g, d),
                      lambda f, g, v, d: ak.advect_bwd_field_plain(v, g, d)),
        "bwd_vel": (lambda f, g, v, d: ak.advect_bwd_vel(f, v, g, d),
                    lambda f, g, v, d: ak.advect_bwd_vel_plain(f, v, g, d)),
    }
    errs = {k: 0.0 for k in pairs}
    cases = [("random", 2.0), ("random", 1.0), ("integer", 2.0),
             ("zero", 1.0)]
    for n, (case, md) in enumerate(cases):
        f, g, v = (torch.from_numpy(a).to(dev)
                   for a in _kernel_inputs(case, md, seed=n))
        case_err = {}
        for key, (kern, plain) in pairs.items():
            out_k = kern(f, g, v, md)
            out_p = plain(f, g, v, md)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out_k).all()):
                raise AssertionError(f"{key}: non-finite output ({case})")
            err = float((out_k - out_p).abs().max())
            case_err[key] = err
            if err > TOL[key]:
                raise AssertionError(
                    f"{key} disagrees with its plain twin on case "
                    f"{case} max_disp={md}: {err} > {TOL[key]}")
            errs[key] = max(errs[key], err)
        emit({"phase": "kernels", "case": case, "max_disp": md,
              "max_abs_err": case_err, "tol": TOL})

    # times at the main path's shape: K1/K2 as the window loss runs them
    # (max_disp 2), K3 as the velocity parameter runs it (max_disp 1)
    records = []
    for key, name, replaces in KERNELS:
        md = 1.0 if key == "bwd_vel" else 2.0
        f, g, v = (torch.from_numpy(a).to(dev)
                   for a in _kernel_inputs("random", md, seed=99))
        kern, plain = pairs[key]
        ms = _median_ms(lambda: kern(f, g, v, md))
        plain_ms = _median_ms(lambda: plain(f, g, v, md))
        records.append({"name": name, "route": "cuda",
                        "source": "nfs_tpu_torch/csrc/advect.cu",
                        "replaces": replaces, "launches": None,
                        "max_abs_err": errs[key], "ms": ms,
                        "plain_ms": plain_ms})
        emit({"phase": "kernel_time", "kernel": name, "max_disp": md,
              "shape": list(SHAPE), "ms": ms, "plain_ms": plain_ms,
              "card": card})
    return records


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


def phase_density(card: str, frames_dir: str):
    """Density parameterization, W=1, 3 frames through FrameStore."""
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
    return launches


def phase_velocity(card: str):
    """Velocity parameterization (config #4), one frame, W=1."""
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
    t0 = time.perf_counter()
    outs = [(d.cpu().numpy(), p.cpu().numpy())
            for _, d, p in styler.stylize_sequence(ds, vs, fused=0)]
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k: ak.LAUNCHES[k] - before[k] for k in before}
    d_star, param = outs[0]
    if d_star.shape != SHAPE or param.shape != SHAPE + (3,):
        raise AssertionError(f"bad shapes {d_star.shape} {param.shape}")
    if not (np.isfinite(d_star).all() and np.isfinite(param).all()):
        raise AssertionError("non-finite velocity-slice output")
    if np.abs(param).max() == 0.0:
        raise AssertionError("velocity parameter never moved")
    if launches["bwd_vel"] <= 0:
        raise AssertionError(f"K3 not launched: {launches}")
    emit({"phase": "velocity", "shape": list(SHAPE), "octave_n": 2,
          "iters": 3, "seconds_incl_warmup": seconds,
          "max_abs_param": float(np.abs(param).max()),
          "launches": launches, "card": card})


_CATEGORIES = (
    # (category, substrings of the kernel name), first match wins
    ("advect kernels K1-K3", ("advect_",)),
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
    emit({"phase": "profile", "shape": list(SHAPE), "window": 1,
          "iters_per_octave": iters, "frame_s": frame_s,
          "steady_s_per_iter": steady,
          "s_per_frame_steady": sum(frame_s[1:]) / (T - 1),
          "traced_iters": n_iter, "traced_wall_s": traced_wall,
          "traced_s_per_iter": traced_wall / n_iter,
          "kernel_ms_per_iter": busy_s * 1e3 / n_iter,
          "idle_share_traced": 1.0 - busy_s / traced_wall,
          "kernel_ms_per_iter_by_category": {
              c: us / 1e3 / n_iter
              for c, us in sorted(by_cat.items(), key=lambda x: -x[1])},
          "top_kernels_ms_per_iter": [
              [us / 1e3 / n_iter, count, name]
              for us, count, name in kernels[:12]],
          "card": card})


def main(argv=None) -> int:
    args = argparse.ArgumentParser(
        description="Drive the PyTorch/CUDA port on one GPU")
    args.add_argument("--profile", action="store_true",
                      help="also profile the density slice at config #3's "
                           "20 iterations per octave")
    args = args.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False; "
                           "this script needs an NVIDIA GPU")
    # the port must come from this checkout: fail before printing anything
    # when the script stands alone
    import nfs_tpu_torch  # noqa: F401

    kind, card = phase_device()

    phase_build()
    records = phase_kernels(card)
    phase_reference(card)
    with tempfile.TemporaryDirectory(prefix="nfs_chip_smoke_") as tmp:
        phase_density(card, tmp)
    phase_velocity(card)
    # launches of the whole main path (density + velocity runs): the
    # counters were reset just before the density run
    from nfs_tpu_torch.ops import advect_kernels as ak

    launches = dict(ak.LAUNCHES)
    if args.profile:
        phase_profile(card)
    for rec, (key, _, _) in zip(records, KERNELS):
        rec["launches"] = launches[key]
        if rec["launches"] <= 0:
            raise AssertionError(f"{rec['name']} never launched")
        if not all(math.isfinite(rec[k])
                   for k in ("max_abs_err", "ms", "plain_ms")):
            raise AssertionError(f"bad numbers in {rec}")
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
