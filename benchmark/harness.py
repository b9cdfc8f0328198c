"""What every cell shares: the command line, the cell's files found by the
names in ``BENCHMARK.json``, the card, the trace's reduction to a summary,
the end-to-end metrics, the per-layer readers, and the result line.

A cell is an entry of ``BENCHMARK.json`` ``workloads``. Its ``config``
names ``configs/<config>.json`` (the sizes, as run), its ``traffic`` names
``traffic/<traffic>.json`` (the mix: jobs, frames, what is checked),
whose ``kind`` names the module ``kinds/<kind>.py`` that drives the
program, and each metric ``<name>``, end-to-end or per-layer, is read by
``metrics/<name>.py`` (up to the name's first dot). Adding a cell, a mix
or a metric adds files and edits none.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import math
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nfs_tpu")

# host-side CUDA launch calls as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel")

# device-time categories by kernel name, first match wins (frozen copy of
# chip_smoke.py _CATEGORIES at commit 7a3f9ef; memcpy and memset events
# fall in 'elementwise')
CATEGORIES = (
    ("advect", ("advect_",)),
    ("binsplat", ("binsplat_",)),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "Conv")),
    ("gemm", ("gemm", "Gemm")),
    ("pool", ("pool",)),
    ("elementwise", ("elementwise", "reduce", "copy", "Copy", "Functor",
                     "Memset", "Memcpy")),
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload with its configuration, traffic mix and metrics."""
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; "
                         f"have {sorted(by_name)}")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return Cell(name=name, chips=int(w["chips"]),
                config=read_json(ROOT / cfg_entry["file"]),
                traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def kind_module(cell: Cell):
    return importlib.import_module(f"benchmark.kinds.{cell.traffic['kind']}")


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` that belong to JAX or to the JAX
    package, compared whole: ``nfs_tpu_torch`` is not ``nfs_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def require_cards(chips: int):
    """The card count the cell asks for, or SystemExit before any
    result is printed."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the "
                         "port on an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# ----------------------------------------------------------------------
# the card (a kind's test runs the same path on the CPU)
# ----------------------------------------------------------------------


def on_card(device) -> bool:
    import torch

    return torch.device(device).type == "cuda"


def load_kernels(device) -> None:
    """Build (a checkout's first run) or load the port's kernels."""
    if on_card(device):
        from nfs_tpu_torch.ops import _cuda_build
        _cuda_build.load_operators()


def sync(device) -> None:
    import torch

    if on_card(device):
        torch.cuda.synchronize()


def open_window(device) -> None:
    """Wait for set-up's work and start the window's memory peak."""
    import torch

    sync(device)
    if on_card(device):
        torch.cuda.reset_peak_memory_stats()


def window_peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if on_card(device) else 0


def release(device) -> None:
    """Return the program's freed memory before the reference runs."""
    import torch

    if on_card(device):
        torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# the trace
# ----------------------------------------------------------------------


def _events(prof):
    """(name, is_device, start_us, end_us) of every profiler event, read
    from Kineto's raw results (building the profiler's event tree would
    take longer than the traced stretch)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), "CUDA" in str(e.device_type()), start,
                    start + e.duration_ns() / 1e3))
    return out


def category(name: str) -> str:
    return next((c for c, keys in CATEGORIES
                 if any(k in name for k in keys)), "other")


def warm_profiler(device) -> None:
    """Start and stop the profiler once on a trivial op: its first start
    initializes the device tracing, seconds that would fall into the
    traced stretch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=device).add_(1).sum().item()


def trace(step, activities, device) -> tuple:
    """(events, host seconds) of ``step()`` run under torch.profiler with
    ``activities``: the seconds from the profiler's start to the end of
    the stretch's last device work, the profiler's own start and stop
    left out. The trace stays in memory."""
    import time

    from torch.profiler import profile

    prof = profile(activities=activities)
    sync(device)
    prof.start()
    t0 = time.perf_counter()
    step()
    sync(device)
    wall = time.perf_counter() - t0
    prof.stop()
    return _events(prof), wall


def reduce_events(events, wall_s: float, iters: int, frames: int,
                  host_events=None) -> Dict:
    """Reduce a traced stretch of ``iters`` Adam iterations (``frames``
    frames) over ``wall_s`` seconds of host clock, given as (name,
    is_device, start_us, end_us) events, to what the per-layer readers
    take: device time by category and by kernel, the union of device
    intervals, host launch calls, and the idle gaps named by the innermost
    host operation running at each gap's middle. ``host_events``: a
    second trace of the same work with the host's operators, which names
    the gaps (``events`` itself by default)."""
    dev = sorted((s, e, n) for n, d, s, e in events if d and e > s)
    named = events if host_events is None else host_events
    host = sorted((s, e, n) for n, d, s, e in named if not d)
    if not dev:
        raise RuntimeError("the profiler saw no device activity")
    by_cat: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        us = e - s
        by_cat[category(n)] = by_cat.get(category(n), 0.0) + us
        by_name[n] = by_name.get(n, 0.0) + us
    busy, gaps = _union(dev)
    if host_events is not None:
        _, gaps = _union(sorted((s, e, n) for n, d, s, e in named
                                if d and e > s))
    starts = [h[0] for h in host]
    by_gap: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host, between operators"
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        by_gap[name] = by_gap.get(name, 0.0) + (g1 - g0)
    launches = sum(1 for n, d, _, _ in events if not d and n in LAUNCH_CALLS)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "iters": iters, "frames": frames, "window_s": wall_s,
        "busy_s": busy / 1e6, "launches": launches,
        "device_s": {c: us / 1e6 for c, us in by_cat.items()},
        "device_ops": [[n[:120], us / 1e6] for n, us in top],
        "idle_gaps": [[n[:120], us / 1e6] for n, us in
                      sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]],
    }


def _union(dev):
    """(busy us, idle gaps) of sorted (start, end, name) device intervals:
    the length of their union and the intervals between its parts."""
    if not dev:
        return 0.0, []
    busy, gaps = 0.0, []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + cur_e - cur_s, gaps


# ----------------------------------------------------------------------
# metrics and the result line
# ----------------------------------------------------------------------


def reader(name: str):
    """The module that reads metric ``name``: ``metrics/<base>.py``, where
    ``base`` is the name up to its first dot. The rest of a dotted name
    says which cells report it (``s_per_frame.joint``), so one reader
    serves every such split."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}")


def read_metrics(entries: List[Dict], data: Dict, required: bool) -> Dict:
    """Each metric's reader on ``data``. A reader that finds nothing to
    read returns None: a per-layer metric is then left out, a required
    (end-to-end) one is an error."""
    out = {}
    for m in entries:
        v = reader(m["name"]).read(data)
        if v is None and not required:
            continue
        if v is None or not math.isfinite(v):
            raise RuntimeError(f"{m['name']} read {v}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


@dataclass
class Check:
    """One number compared with its limit; ``ok`` when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a kind's run hands back to the harness."""
    frames: int                    # output frames finished in the window
    window_s: float                # the window's host seconds
    setup_s: float                 # process start to the window's open
    peak_bytes: int                # max_memory_allocated over the window
    failed: int = 0                # frames that never came or were not finite
    checks: List[Check] = field(default_factory=list)
    summary: Optional[Dict] = None  # the trace's, with --trace 1
    extra: Dict = field(default_factory=dict)  # a kind's own readings

    def window(self) -> Dict:
        """What the end-to-end readers read: the window's numbers and
        whatever else the kind recorded."""
        return {"frames": self.frames, "window_s": self.window_s,
                "setup_s": self.setup_s, "peak_bytes": self.peak_bytes,
                **self.extra}


def result(cell: Cell, out: Outcome, trace: bool, kind_name: str,
           count: int, card: str) -> Dict:
    correct = out.failed == 0 and bool(out.checks) and all(
        c.ok for c in out.checks)
    if trace:
        metrics = read_metrics(cell.per_layer, out.summary, required=False)
    else:
        metrics = read_metrics(cell.end_to_end, out.window(), required=True)
    device = {"platform": "gpu", "kind": kind_name, "count": count,
              "memory_peak_bytes": int(out.peak_bytes)}
    line = {"correct": correct, "attempted": out.frames,
            "failed": out.failed, "metrics": metrics, "device": device,
            "card": card}
    if trace:
        s = out.summary
        device["busy_s"] = s["busy_s"]
        device["window_s"] = s["window_s"]
        line["breakdown"] = {"device_ops": s["device_ops"],
                             "idle_gaps": s["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line
