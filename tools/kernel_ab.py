#!/usr/bin/env python3
"""The port's kernels against the parent commit's, and its launch path
against PyTorch's, on one GPU.

    python3 tools/kernel_ab.py kernels PARENT_CSRC
    python3 tools/kernel_ab.py far PARENT_ROOT
    python3 tools/kernel_ab.py host

``kernels`` prints, on ``chip_smoke.py``'s kernel inputs, the largest
difference between this checkout's six kernels and the parent commit's
and whether they are bitwise equal (K5 also on the coarsest octave's
bins, and this checkout's K2 wrapper against the parent's K2 route at
max_disp 8, 9 and 12: the tiled pull within its plan, the untiled pull
past it); then every kernel's two timers from ``chip_smoke.py``
(``ms``: one call between CUDA events, host included; ``device_ms``:
queued calls) in turns this, parent, parent, this, this checkout's
through its wrapper, the parent's through its C interface (K5 at the
finest and the coarsest octave, K2 also at max_disp 9 and 12), and K1's
``F.grid_sample``. ``PARENT_CSRC`` is a directory holding the parent's
``advect.cu``, ``binsplat.cu`` and ``launch.cuh`` (``git show
REV:nfs_tpu_torch/csrc/advect.cu > build/parent_csrc/advect.cu`` and so
on before the call: the GPU machine has no git); both sources are built
with nvcc beside
this checkout's and launched through the parent's C interface
(``_Parent``). Then K1 with four cells along x per thread and float4
displacement loads (``tools/k1_cells_x.cu``) against the shipped K1:
bits on the same inputs and on three ragged shapes, and times in
turns.

``far`` runs ``chip_smoke.py``'s far frame (the density slice's first
frame at max_disp 9, 3 octaves x 4 iterations) in turns this, parent,
parent, this, each run a process of its own that imports
``nfs_tpu_torch`` from its checkout (``PARENT_ROOT``: the parent
commit unpacked, e.g. ``git archive REV | tar -x -C build/parent``
before the call) and builds that checkout's kernels. Each run prints
the finest octave's seconds per iteration without its first iteration
(``chip_smoke._warm_s_per_iter``), that first iteration with the resize
into the octave, the run's seconds and K1-K3b launches, and its d*'s
largest difference from the first run's.

``host`` prints, for one call of K1 (112x64x112, max_disp 2) and one of
K4 (the particle path's finest octave, K = 4), the host microseconds
per call of this checkout's wrapper (through its ``TORCH_LIBRARY``
operator, ``nfs_tpu_torch/csrc/ops.cpp``), of the operator alone, of
the allocation, of the same C entry point reached through ``ctypes``
(a one-pass check in Python, the allocation, the raw stream handle and
the call, whole and piece by piece, with the call also refused before
it launches), of PyTorch's device guard and ``torch.cuda.Stream``
object, which neither route builds, and of the library call
(``F.grid_sample`` for K1): each piece called 400 times while the
device is held behind a ``torch.cuda._sleep``, the median of 7 batches
(``chip_smoke.py``'s ``_host_us``). Then the wrapper, the ``ctypes``
route and the library call with ``chip_smoke.py``'s two timers and the
host timer, in turns wrapper, ctypes, library, library, ctypes,
wrapper. It also prints the seconds the three libraries take to build.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "kernel_ab"
# K4's and K5's bin capacity at the particle path's finest octave
BIN_K = 4
CALLS, BATCHES = 400, 7


def _nvcc(source: Path, so: Path) -> Path:
    from nfs_tpu_torch.ops import _cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_cuda_build.find_nvcc(), *_cuda_build.NVCC_FLAGS,
                           "-o", str(so), str(source)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return so


def _parent_libs(parent: Path):
    """The parent's two libraries with the parent's argtypes (each entry
    point ends in the device index and the stream)."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    adv = ctypes.CDLL(str(_nvcc(parent / "advect.cu",
                                OUT / "libparent_advect.so")))
    adv.nfs_advect_fwd.argtypes = [p, p, p, i, i, i, i, f, i, p]
    adv.nfs_advect_bwd_field.argtypes = [p, p, p, i, i, i, i, f] + [
        i] * 5 + [i, p]
    adv.nfs_advect_bwd_field_untiled.argtypes = [p, p, p, i, i, i, i, f, i,
                                                 i, p]
    adv.nfs_advect_bwd_vel.argtypes = [p, p, p, p, i, i, i, i, f, i, p]
    adv.nfs_advect_bwd_fused.argtypes = [p] * 5 + [i, i, i, i, f] + [
        i] * 5 + [i, p]
    bins = ctypes.CDLL(str(_nvcc(parent / "binsplat.cu",
                                 OUT / "libparent_binsplat.so")))
    bins.nfs_binsplat_fwd.argtypes = [p] * 5 + [i] * 5 + [i, p]
    bins.nfs_binsplat_bwd.argtypes = [p] * 9 + [i] * 5 + [i, p]
    return adv, bins


def _host_us(fn) -> float:
    """chip_smoke.py's host timer at CALLS calls and BATCHES batches."""
    return cs._host_us(fn, calls=CALLS, batches=BATCHES)


def _times(fn, host: bool = False) -> dict:
    t = {"ms": cs._median_ms(fn), "device_ms": cs._device_ms(fn)}
    if host:
        t["host_us"] = _host_us(fn)
    return t


def _turns(this, other, names=("this", "parent")) -> dict:
    """chip_smoke.py's two timers, in turns this, other, other, this."""
    turns = {name: [] for name in names}
    for who in (0, 1, 1, 0):
        turns[names[who]].append(_times((this, other)[who]))
    return turns


# --------------------------------------------------------------------- #
# host: this checkout's launch path, piece by piece, against ctypes
# --------------------------------------------------------------------- #

def _ctypes_entry_points():
    """This checkout's two kernel libraries through ctypes."""
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops import binsplat_kernels as bk

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    adv = ctypes.CDLL(str(ak.build_library()))
    adv.nfs_advect_fwd.argtypes = [p, p, p, i, i, i, i, f, i, p]
    bins = ctypes.CDLL(str(bk.build_library()))
    bins.nfs_binsplat_fwd.argtypes = [p] * 5 + [i] * 5 + [i, p]
    return adv, bins


def _ctypes_check(tensors, shapes):
    """One pass of the operators' checks in Python."""
    import torch

    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if (t.dtype is not torch.float32 or t.shape != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError("bad input")
    return tensors[0].get_device()


def _guard(dev):
    import torch

    with torch.cuda.device(dev):
        pass


def host(card: str) -> None:
    import torch

    from nfs_tpu_torch.ops import _cuda_build
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops import binsplat_kernels as bk

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _cuda_build.build_operators()
    ops = _cuda_build.load_operators()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0,
             "card": card})
    adv, bins = _ctypes_entry_points()
    raw_stream = torch._C._cuda_getCurrentRawStream

    f, g, v = cs._cuda_inputs("random", 2.0, seed=99)
    D, H, W = f.shape
    out = torch.empty_like(f)
    ptrs = (f.data_ptr(), v.data_ptr(), out.data_ptr())

    def k1_ctypes():
        d = _ctypes_check((f, v), ((D, H, W), (D, H, W, 3)))
        o = torch.empty_like(f)
        rc = adv.nfs_advect_fwd(f.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                                D, H, W, 2.0, d, raw_stream(d))
        if rc != 0:
            raise RuntimeError(rc)
        return o

    if not (cs._equal(k1_ctypes(), ak.advect_fwd(f, v, 2.0))):
        raise AssertionError("K1 through ctypes differs from the wrapper")
    k1 = {
        "wrapper (operator)": lambda: ak.advect_fwd(f, v, 2.0),
        "operator alone": lambda: ops.advect_fwd.default(f, v, 2.0),
        "allocation (empty_like)": lambda: torch.empty_like(f),
        "ctypes route": k1_ctypes,
        "ctypes route: check in Python": lambda: _ctypes_check(
            (f, v), ((D, H, W), (D, H, W, 3))),
        "ctypes route: stream (raw handle)": lambda: raw_stream(0),
        "ctypes route: call and launch": lambda: adv.nfs_advect_fwd(
            *ptrs, 1, D, H, W, 2.0, 0, raw_stream(0)),
        "ctypes route: call refused before launching":
            lambda: adv.nfs_advect_fwd(*ptrs, 1, 1, 1 << 16, 1 << 16, 2.0,
                                       0, raw_stream(0)),
        "device guard (with torch.cuda.device)": lambda: _guard(dev),
        "stream as a torch.cuda.Stream object": lambda: (
            torch.cuda.current_stream(dev).cuda_stream),
        "library (F.grid_sample)": cs._advect_library_call("fwd", f, g, v,
                                                           2.0),
    }
    _emit_host("advect_fwd (K1)", k1, card)
    _emit_turns("advect_fwd (K1)", {
        "wrapper": k1["wrapper (operator)"], "ctypes": k1_ctypes,
        "library": k1["library (F.grid_sample)"]}, card)

    a4, p4, g4, _, _ = cs._bin_inputs("binned", BIN_K, seed=99)
    K, Z, Y, X = a4.shape
    bout = torch.empty((Z, Y, X), dtype=torch.float32, device=dev)
    bptrs = (a4.data_ptr(), *(p.data_ptr() for p in p4), bout.data_ptr())

    def k4_ctypes():
        d = _ctypes_check((a4, *p4), (a4.shape,) * 4)
        o = torch.empty((Z, Y, X), dtype=torch.float32, device=a4.device)
        rc = bins.nfs_binsplat_fwd(a4.data_ptr(),
                                   *(p.data_ptr() for p in p4),
                                   o.data_ptr(), 1, K, Z, Y, X, d,
                                   raw_stream(d))
        if rc != 0:
            raise RuntimeError(rc)
        return o

    if not cs._equal(k4_ctypes(), bk.binsplat_fwd(a4, *p4)):
        raise AssertionError("K4 through ctypes differs from the wrapper")
    k4 = {
        "wrapper (operator)": lambda: bk.binsplat_fwd(a4, *p4),
        "operator alone": lambda: ops.binsplat_fwd.default(a4, *p4),
        "allocation (empty)": lambda: torch.empty(
            (Z, Y, X), dtype=torch.float32, device=a4.device),
        "ctypes route": k4_ctypes,
        "ctypes route: check in Python": lambda: _ctypes_check(
            (a4, *p4), (a4.shape,) * 4),
        "ctypes route: call and launch": lambda: bins.nfs_binsplat_fwd(
            *bptrs, 1, K, Z, Y, X, 0, raw_stream(0)),
        "ctypes route: call refused before launching":
            lambda: bins.nfs_binsplat_fwd(*bptrs, 1, K, 1 << 16, 1 << 16, X,
                                          0, raw_stream(0)),
    }
    _emit_host("binsplat_fwd (K4)", k4, card)
    _emit_turns("binsplat_fwd (K4)", {"wrapper": k4["wrapper (operator)"],
                                      "ctypes": k4_ctypes}, card)


def _emit_host(kernel: str, pieces: dict, card: str) -> None:
    us = {name: _host_us(fn) for name, fn in pieces.items()}
    cs.emit({"phase": "host_us", "kernel": kernel, "us_per_call": us,
             "calls": CALLS, "batches": BATCHES, "card": card})


def _emit_turns(kernel: str, calls: dict, card: str) -> None:
    """The calls' times in turns: in order, then in reverse."""
    names = list(calls)
    turns = {name: [] for name in names}
    for name in names + names[::-1]:
        turns[name].append(_times(calls[name], host=True))
    cs.emit({"phase": "launch_path_turns", "kernel": kernel, **turns,
             "card": card})


# --------------------------------------------------------------------- #
# kernels: bits and times against the parent's kernels
# --------------------------------------------------------------------- #

class _Parent:
    """The parent's kernels on single frames, launched through its C
    interface (the batch before the volume's shape, the device index and
    the stream last) with this checkout's tile plans, which the parent's
    K2 / K3b share; the parent's K2 route past the plan is its untiled
    pull. A change to the parent's C interface changes this class and
    :func:`_parent_libs`."""

    def __init__(self, parent: Path):
        import torch

        self.adv, self.bins = _parent_libs(parent)
        self.device = torch.cuda.current_device()
        self.stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def _run(self, fn, what, *args):
        rc = fn(*args, self.device, self.stream)
        if rc != 0:
            raise RuntimeError(f"parent {what}: CUDA error {rc}")

    def fwd(self, f, g, v, md):
        import torch

        out = torch.empty_like(f)
        self._run(self.adv.nfs_advect_fwd, "fwd", f.data_ptr(), v.data_ptr(),
                  out.data_ptr(), 1, *f.shape, md)
        return out

    def bwd_field(self, f, g, v, md):
        import torch

        from nfs_tpu_torch.ops import advect_kernels as ak

        R = ak._radius(md)
        plan = ak._pull_plan(R)
        out = torch.empty_like(g)
        if plan is None:
            self._run(self.adv.nfs_advect_bwd_field_untiled,
                      "bwd_field_untiled", v.data_ptr(), g.data_ptr(),
                      out.data_ptr(), 1, *g.shape, md, R)
        else:
            self._run(self.adv.nfs_advect_bwd_field, "bwd_field",
                      v.data_ptr(), g.data_ptr(), out.data_ptr(), 1,
                      *g.shape, md, R, *plan)
        return out

    def bwd_vel(self, f, g, v, md):
        import torch

        out = torch.empty_like(v)
        self._run(self.adv.nfs_advect_bwd_vel, "bwd_vel", f.data_ptr(),
                  v.data_ptr(), g.data_ptr(), out.data_ptr(), 1, *f.shape,
                  md)
        return out

    def bwd_fused(self, f, g, v, md):
        import torch

        from nfs_tpu_torch.ops import advect_kernels as ak

        R = ak._radius(md)
        gf, gs = torch.empty_like(g), torch.empty_like(v)
        self._run(self.adv.nfs_advect_bwd_fused, "bwd_fused", f.data_ptr(),
                  v.data_ptr(), g.data_ptr(), gf.data_ptr(), gs.data_ptr(),
                  1, *f.shape, md, R, *ak._pull_plan(R, fused=True))
        return gf, gs

    def binsplat_fwd(self, a4, p4):
        import torch

        out = torch.empty(a4.shape[1:], dtype=torch.float32,
                          device=a4.device)
        self._run(self.bins.nfs_binsplat_fwd, "binsplat_fwd", a4.data_ptr(),
                  *(p.data_ptr() for p in p4), out.data_ptr(), 1, *a4.shape)
        return out

    def binsplat_bwd(self, a4, p4, g):
        import torch

        outs = [torch.empty_like(a4) for _ in range(4)]
        self._run(self.bins.nfs_binsplat_bwd, "binsplat_bwd", a4.data_ptr(),
                  *(p.data_ptr() for p in p4), g.data_ptr(),
                  *(o.data_ptr() for o in outs), 1, *a4.shape)
        return tuple(outs)


def _cells_x_lib():
    """tools/k1_cells_x.cu, built with the port's flags."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = ctypes.CDLL(str(_nvcc(ROOT / "tools" / "k1_cells_x.cu",
                                OUT / "libk1_cells_x.so")))
    lib.nfs_advect_fwd_cells_x.argtypes = [p, p, p, i, i, i, f, i, p]
    lib.nfs_advect_fwd_cells_x.restype = ctypes.c_int
    return lib


def _k1_cells_x(lib, f, v, md):
    import torch

    out = torch.empty_like(f)
    d = f.get_device()
    rc = lib.nfs_advect_fwd_cells_x(f.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), *f.shape, md, d,
                                    torch._C._cuda_getCurrentRawStream(d))
    if rc != 0:
        raise RuntimeError(f"advect_fwd_cells_x: CUDA error {rc}")
    return out


def kernels(parent_dir: Path, card: str) -> None:
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.ops import binsplat_kernels as bk

    parent = _Parent(parent_dir)
    pairs = cs._advect_pairs()
    # the coarsest octave's grid and the K the styler plans for it
    coarse_grid, coarse_k = cs._octave_ks()[0]
    # bits of all four advection kernels on chip_smoke.py's kernel cases
    # (seeds 0-5) and its timing inputs (seed 99), and of K2's wrapper
    # (the binned route from BINNED_FROM_R) against the parent's K2 route
    # (the tiled pull at max_disp 8, the untiled one at 9 and 12)
    cases = [("random", 2.0, 0), ("random", 1.0, 1), ("integer", 2.0, 2),
             ("zero", 1.0, 3), ("random", 3.0, 4), ("swirl", 2.0, 5),
             ("random", 2.0, 99), ("random", 8.0, 7), ("random", 9.0, 8),
             ("random", 12.0, 9)]
    for case, md, seed in cases:
        f, g, v = cs._cuda_inputs(case, md, seed=seed)
        diff = {}
        for key, (kern, _) in pairs.items():
            if md > 3.0 and key != "bwd_field":
                continue
            old = getattr(parent, key)(f, g, v, md)
            new = kern(f, g, v, md)
            diff[key] = (cs._max_err(new, old), cs._equal(new, old))
        cs.emit({"phase": "bits", "inputs": case, "max_disp": md,
                 "seed": seed, "max_abs_diff": {k: d[0] for k, d in
                                                diff.items()},
                 "bitwise_equal": {k: d[1] for k, d in diff.items()},
                 "card": card})
    bins = {}
    for label, case, K, seed, grid in (
            ("binned", "binned", BIN_K, 0, cs.P_GRID),
            ("drifted", "drifted", BIN_K, 1, cs.P_GRID),
            ("crowded", "crowded", 2, 2, cs.P_GRID),
            ("integer", "integer", BIN_K, 3, cs.P_GRID),
            ("finest", "binned", BIN_K, 99, cs.P_GRID),
            ("coarsest", "binned", coarse_k, 98, coarse_grid)):
        bins[label] = cs._bin_inputs(case, K, seed=seed, grid=grid)
        a4, p4, g = bins[label][:3]
        this = (bk.binsplat_fwd(a4, *p4), bk.binsplat_bwd(a4, *p4, g))
        old = (parent.binsplat_fwd(a4, p4), parent.binsplat_bwd(a4, p4, g))
        cs.emit({"phase": "bits", "inputs": label, "K": K, "seed": seed,
                 "max_abs_diff": {"binsplat_fwd": cs._max_err(this[0],
                                                              old[0]),
                                  "binsplat_bwd": cs._max_err(this[1],
                                                              old[1])},
                 "bitwise_equal": {"binsplat_fwd": cs._equal(this[0], old[0]),
                                   "binsplat_bwd": cs._equal(this[1],
                                                             old[1])},
                 "card": card})

    # every kernel in turns against the parent's: the advection kernels
    # at chip_smoke.py's timing inputs (K3 at max_disp 1), K1 and the
    # pull kernels also on the swirl, K2 also past the tile plan
    for key, case, md in (("fwd", "random", 2.0), ("fwd", "swirl", 2.0),
                          ("bwd_field", "random", 2.0),
                          ("bwd_field", "swirl", 2.0),
                          ("bwd_field", "random", 9.0),
                          ("bwd_field", "random", 12.0),
                          ("bwd_vel", "random", 1.0),
                          ("bwd_fused", "random", 2.0)):
        f, g, v = cs._cuda_inputs(case, md, seed=99)
        kern = pairs[key][0]
        rec = {"phase": "kernel_ab", "kernel": key, "inputs": case,
               "max_disp": md,
               **_turns(lambda: kern(f, g, v, md),
                        lambda: getattr(parent, key)(f, g, v, md))}
        if key == "fwd":
            rec["library"] = _times(cs._advect_library_call("fwd", f, g, v,
                                                            md))
        cs.emit(dict(rec, card=card))
    for octave in ("finest", "coarsest"):
        a4, p4, g = bins[octave][:3]
        for key in (("binsplat_fwd", "binsplat_bwd") if octave == "finest"
                    else ("binsplat_bwd",)):
            if key == "binsplat_fwd":
                this = lambda: bk.binsplat_fwd(a4, *p4)     # noqa: E731
                that = lambda: parent.binsplat_fwd(a4, p4)     # noqa: E731
            else:
                this = lambda: bk.binsplat_bwd(a4, *p4, g)     # noqa: E731
                that = lambda: parent.binsplat_bwd(a4, p4, g)  # noqa: E731
            cs.emit({"phase": "kernel_ab", "kernel": key, "inputs": octave,
                     "K": a4.shape[0], **_turns(this, that), "card": card})

    # K1 with cells along x and float4 loads against the shipped K1
    lib = _cells_x_lib()
    ragged = [("random", 2.0, 6, (35, 20, 35)), ("random", 2.0, 7, (5, 3, 8)),
              ("random", 2.0, 8, (3, 4, 9))]
    for case, md, seed, shape in [
            (c, m, s, cs.SHAPE) for c, m, s in cases] + ragged:
        if shape == cs.SHAPE:
            f, g, v = cs._cuda_inputs(case, md, seed=seed)
        else:
            rng = np.random.default_rng(seed)
            f = torch.from_numpy(rng.random(shape, dtype=np.float32)).cuda()
            v = torch.from_numpy(md * rng.standard_normal(
                shape + (3,), dtype=np.float32)).cuda()
        want = ak.advect_fwd(f, v, md)
        got = _k1_cells_x(lib, f, v, md)
        cs.emit({"phase": "bits", "kernel": "advect_fwd_cells_x",
                 "inputs": case, "max_disp": md, "seed": seed,
                 "shape": list(shape),
                 "max_abs_diff": cs._max_err(got, want),
                 "bitwise_equal": cs._equal(got, want), "card": card})
    for case in ("random", "swirl"):
        f, g, v = cs._cuda_inputs(case, 2.0, seed=99)
        cs.emit({"phase": "k1_cells_x_ab", "inputs": case, "max_disp": 2.0,
                 **_turns(lambda: ak.advect_fwd(f, v, 2.0),
                          lambda: _k1_cells_x(lib, f, v, 2.0),
                          names=("shipped", "cells_x")),
                 "card": card})


# --------------------------------------------------------------------- #
# far: the far phase's frame, this checkout against the parent's
# --------------------------------------------------------------------- #

def far_run(root: Path, first: Path) -> None:
    """One far-frame run with ``nfs_tpu_torch`` imported from ``root``;
    its d* is written to ``first`` when that file is absent, else held
    against it. Prints one JSON line."""
    sys.path.insert(0, str(root))
    import torch

    import nfs_tpu_torch
    from nfs_tpu_torch.ops import _cuda_build
    from nfs_tpu_torch.ops import advect_kernels as ak
    from nfs_tpu_torch.styler.grid import GridStyler

    if Path(nfs_tpu_torch.__file__).resolve().parents[1] != root.resolve():
        raise RuntimeError(f"imported {nfs_tpu_torch.__file__}, not {root}")
    t0 = time.perf_counter()
    _cuda_build.load_operators()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(4)
    ds = cs._plume_density(cs.SHAPE, 0, rng)[None]
    vs = cs._swirl_velocity(cs.SHAPE, 0)[None]
    style = np.random.default_rng(1).random((256, 256, 3), dtype=np.float32)
    cfg = cs._northstar_cfg(**{"optim.iters": 4, "optim.max_disp": 9.0})
    styler = GridStyler(cfg, style_image=style, device="cuda")
    marks = []
    ak.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = [d.cpu().numpy() for _, d, _ in styler.stylize_sequence(
        ds, vs, fused=0, callback=lambda done, loss, octave:
        marks.append((octave, done, time.perf_counter())))][0]
    seconds = time.perf_counter() - t0
    finest = cfg.optim.octave_n - 1
    t_in = max(t for o, _, t in marks if o == finest - 1)
    t_first = min(t for o, _, t in marks if o == finest)
    if first.exists():
        d_diff = float(np.abs(d - np.load(first)).max())
    else:
        np.save(first, d)
        d_diff = 0.0
    print(json.dumps({
        "package": str(Path(nfs_tpu_torch.__file__).parent),
        "build_s": build_s, "seconds": seconds,
        "finest_s_per_iter_warm": cs._warm_s_per_iter(marks, finest),
        "finest_first_iter_s": t_first - t_in,
        "launches": {k: n for k, n in ak.LAUNCHES.items() if n},
        "d_star_finite": bool(np.isfinite(d).all()),
        "d_star_max_abs_diff_vs_first_run": d_diff}), flush=True)


def far(parent_root: Path, card: str) -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    first = OUT / "far_first_d_star.npy"
    first.unlink(missing_ok=True)
    for label, root in (("this", ROOT), ("parent", parent_root),
                        ("parent", parent_root), ("this", ROOT)):
        proc = subprocess.run(
            [sys.executable, __file__, "far_run", str(root), str(first)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"far run of {root} failed:\n{proc.stderr}")
        cs.emit({"phase": "far_ab", "checkout": label,
                 **json.loads(proc.stdout.strip().splitlines()[-1]),
                 "card": card})


def main(argv) -> int:
    import torch

    if argv[:1] == ["far_run"] and len(argv) == 3:
        far_run(Path(argv[1]), Path(argv[2]))
        return 0
    if not ((argv[:1] in (["kernels"], ["far"]) and len(argv) == 2)
            or argv == ["host"]):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA device")
    card = cs.phase_device()[1]
    if argv[0] == "host":
        host(card)
    elif argv[0] == "far":
        far(Path(argv[1]).resolve(), card)
    else:
        kernels(Path(argv[1]), card)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
