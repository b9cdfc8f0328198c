"""Profiling helpers (counterpart of ``nfs_tpu/utils/profiling.py``):
a ``torch.profiler`` trace context, the program's spans, and wall-clock
timers that synchronize the device, so that asynchronous CUDA launches do
not hide the work.

Usage:
    with trace("log/trace") as prof:      # Chrome trace in log/trace/
        run_octave(...)
    print(prof.key_averages().table(sort_by="cuda_time_total"))

    with span("nfs.render"):               # a range in that trace
        render_views(...)

    timer = IterationTimer(device="cuda")
    with timer:                            # synchronized wall time
        step(...)
    print(timer.last_ms, timer.mean_ms)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

import torch


_OFF = contextlib.nullcontext()


def span(name: str, args: Optional[dict] = None):
    """A named range of the program, for the profiler.

    While no ``torch.profiler`` records, this returns one shared null
    context: no clock is read, nothing is allocated or recorded. While one
    records, it is a ``RecordFunction`` range: a CPU operator event named
    ``name`` in the same Kineto trace as the device's kernels and on the
    same clock, so that each kernel and each idle gap of the device can be
    put down to the range the host was in. ``args`` names the request
    (``{"frame": t}``); the trace shows it when the profiler records
    shapes. The range is an operator event, not a user annotation, so it
    adds no interval to the device's timeline: a trace's busy and idle
    time stay those of its kernels, copies and memsets.

    The program's spans, each named ``nfs.<layer>``, are listed in
    PERF.md §3."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name, [], args or {})


def _sync(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block: CPU activity, plus CUDA when a
    GPU is present; on exit the trace is written to ``log_dir`` as a
    Chrome trace (``trace_<pid>_<ms>.json``). Yields the profiler. A
    profiler that fails to start or stop raises: unlike the JAX
    version's, a failure is not swallowed, since it would hide the
    device."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


class IterationTimer:
    """Wall-clock timer that synchronizes ``device`` on exit, so the time
    includes the device's work and not only its launch."""

    def __init__(self, device="cuda"):
        self.device = device
        self.times_ms: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.times_ms.append((time.perf_counter() - self._t0) * 1000.0)
        return False

    @property
    def last_ms(self) -> float:
        return self.times_ms[-1] if self.times_ms else 0.0

    @property
    def mean_ms(self) -> float:
        return (sum(self.times_ms) / len(self.times_ms)
                if self.times_ms else 0.0)


def timed(fn, *args, n: int = 10, warmup: int = 1, device="cuda"):
    """Steady-state latency of ``fn(*args)``: (mean ms over ``n`` calls
    after ``warmup`` calls, last result), the device synchronized before
    and after the timed calls."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        result = fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / n * 1000.0, result
