"""The program's spans in a traced stretch: device time, launch and
synchronizing calls, and device idle time, each put down to the
``nfs.*`` span of ``nfs_tpu_torch`` that the host was in.

``reduce`` takes the raw events of a trace that holds the host's
operators (``raw_events``) and attributes:

- each kernel, copy and memset to the innermost span enclosing its launch
  call on the launching thread. A launch inside an autograd node
  (``autograd::engine::evaluate_function``) goes to the span that enclosed
  the node's forward operator, found by the node's ``(sequence_nr,
  fwd_thread_id)``: a layer's time is its forward plus its backward. A
  launch on another thread outside any span or node goes to the span the
  main thread was in; the rest is ``unspanned``;
- each launch call (``harness.LAUNCH_CALLS``) and synchronizing call
  (``cuda*Synchronize``) by the same rule;
- each gap between the device's busy intervals to the innermost span open
  on the main thread (the one holding the most span time) at the gap's
  middle, and to ``nfs.iter`` where that span was open there.

Iterations are the ``nfs.iter`` spans of the main thread. A trace of a
program without spans attributes everything to ``unspanned`` and counts
no iterations.

Run one cell traced, as ``run.py --trace 1`` does, and print its span
breakdown as a JSON line (the harness's line under ``line``):

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import json
import sys
import time
from collections import namedtuple
from typing import Dict, Iterable, List

from benchmark import harness

PREFIX = "nfs."
NODE = "autograd::engine::evaluate_function"
UNSPANNED = "unspanned"

# one profiler event: device work (kernel, copy, memset) or a host event
# (operator, span, runtime call); times in microseconds
Event = namedtuple("Event", "name device start end thread corr seq fwd")

# the per-layer quantities, each read from these spans
LAYERS = {
    "render": ("nfs.render",),
    "features": ("nfs.features",),
    "adam": ("nfs.adam",),
    "transport": ("nfs.transport",),
    "splat": ("nfs.splat", "nfs.bin_plan"),
}


def raw_events(prof) -> List[Event]:
    """The events of a stopped ``torch.profiler.profile``, read from
    Kineto's raw results. GPU user annotations (the device-side shadow of
    a ``record_function`` range) are not device work and are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == DeviceType.CUDA
        if device and e.is_user_annotation():
            continue
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), device, start,
                         start + e.duration_ns() / 1e3, e.start_thread_id(),
                         e.correlation_id(), e.sequence_nr(),
                         e.fwd_thread_id()))
    return out


def _open(intervals, queries) -> List[tuple]:
    """For each query (thread, t), the payloads of ``intervals`` (thread,
    start, end, payload; nested within a thread) open on that thread at
    t, outermost first."""
    by_thread: Dict[int, list] = {}
    for th, s, e, p in intervals:
        by_thread.setdefault(th, []).append((s, -e, p))
    for iv in by_thread.values():
        iv.sort(key=lambda x: (x[0], x[1]))
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    out: List[tuple] = [()] * len(queries)
    cur_thread, iv, k, stack = None, [], 0, []
    for i in order:
        th, t = queries[i]
        if th != cur_thread:
            cur_thread, iv, k, stack = th, by_thread.get(th, []), 0, []
        while k < len(iv) and iv[k][0] <= t:
            _, neg_e, p = iv[k]
            while stack and stack[-1][0] < -neg_e:
                stack.pop()
            stack.append((-neg_e, p))
            k += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out[i] = tuple(p for _, p in stack)
    return out


def _add(d: Dict, key, value) -> None:
    d[key] = d.get(key, 0) + value


def reduce(events: Iterable[Event]) -> Dict:
    """Device seconds (also split by ``harness.category`` of the kernel),
    launch and synchronizing calls, and idle seconds, each by span
    (innermost), and the idle seconds inside ``nfs.iter``; see the
    module's docstring."""
    events = list(events)
    host = [e for e in events if not e.device]
    device = sorted((e for e in events if e.device and e.end > e.start),
                    key=lambda e: e.start)
    spans = [e for e in host if e.name.startswith(PREFIX)]
    span_time: Dict[int, float] = {}
    for e in spans:
        _add(span_time, e.thread, e.end - e.start)
    main = max(span_time, key=span_time.get) if span_time else None
    span_iv = [(e.thread, e.start, e.end, e.name) for e in spans]
    nodes = [(e.thread, e.start, e.end, (e.seq, e.fwd)) for e in host
             if e.name.startswith(NODE) and e.seq >= 0]
    # the forward operator that made node (seq, thread): every operator
    # through autograd records the sequence number the next node will
    # take, so the one that took it is the last to start with it
    forward: Dict[tuple, float] = {}
    for e in host:
        if (e.seq >= 0 and e.fwd == 0 and not e.name.startswith(PREFIX)
                and not e.name.startswith(NODE)):
            key = (e.thread, e.seq)
            forward[key] = max(forward.get(key, e.start), e.start)
    runtime = {e.corr: e for e in host if e.name.startswith("cu")}

    # the points to attribute: each device event's launch call, each
    # launch call and each synchronizing call
    points, what = [], []
    for d in device:
        r = runtime.get(d.corr)
        points.append((r.thread, r.start) if r else None)
        what.append((harness.category(d.name), d.end - d.start))
    for e in runtime.values():
        if e.name in harness.LAUNCH_CALLS:
            kind = "launches"
        elif "Synchronize" in e.name:
            kind = "syncs"
        else:
            continue
        points.append((e.thread, e.start))
        what.append((kind, 1))
    located = [p for p in points if p is not None]
    inner = iter(_open(span_iv + nodes, located))
    first = [next(inner) if p is not None else () for p in points]
    # a launch inside an autograd node: the span of the node's forward
    fwd_q, fwd_i = [], []
    for i, stack in enumerate(first):
        top = stack[-1] if stack else None
        if isinstance(top, tuple) and (top[1], top[0]) in forward:
            fwd_q.append((top[1], forward[(top[1], top[0])]))
            fwd_i.append(i)
    names: List = [None] * len(points)
    for i, stack in zip(fwd_i, _open(span_iv, fwd_q)):
        names[i] = stack[-1] if stack else None
    # else the innermost span on the launching thread, else the one the
    # main thread was in
    main_q, main_i = [], []
    for i, (p, stack) in enumerate(zip(points, first)):
        if names[i] is not None or p is None:
            continue
        here = [s for s in stack if isinstance(s, str)]
        if here:
            names[i] = here[-1]
        elif p[0] != main:
            main_q.append((main, p[1]))
            main_i.append(i)
    for i, stack in zip(main_i, _open(span_iv, main_q)):
        names[i] = stack[-1] if stack else None
    calls = {"launches": {}, "syncs": {}}
    by_cat: Dict[str, Dict[str, float]] = {}
    for name, (kind, amount) in zip(names, what):
        name = name or UNSPANNED
        if kind in calls:
            _add(calls[kind], name, amount)
        else:   # a kernel's category and microseconds
            _add(by_cat.setdefault(name, {}), kind, amount / 1e6)

    # idle: the gaps between the device's busy intervals
    gaps, cur_end = [], None
    for d in device:
        if cur_end is not None and d.start > cur_end:
            gaps.append((cur_end, d.start))
        cur_end = d.end if cur_end is None else max(cur_end, d.end)
    idle: Dict[str, float] = {}
    in_iter = 0.0
    mids = [(main, 0.5 * (g0 + g1)) for g0, g1 in gaps]
    for (g0, g1), stack in zip(gaps, _open(span_iv, mids)):
        _add(idle, stack[-1] if stack else UNSPANNED, g1 - g0)
        if "nfs.iter" in stack:
            in_iter += g1 - g0
    iters = sum(1 for e in spans if e.name == "nfs.iter"
                and e.thread == main)
    return {
        "iters": iters,
        "device_s": {k: sum(v.values()) for k, v in by_cat.items()},
        "device_by_category_s": by_cat,
        "launches": calls["launches"], "syncs": calls["syncs"],
        "idle_s": {k: v / 1e6 for k, v in idle.items()},
        "idle_in_iter_s": in_iter / 1e6,
        "idle_total_s": sum(g1 - g0 for g0, g1 in gaps) / 1e6,
    }


def layer_ms_per_iter(spans: Dict, layer: str):
    """Device milliseconds per iteration under the spans of ``layer``
    (``LAYERS``), or None without iterations or without those spans."""
    dev = spans["device_s"]
    if not spans["iters"] or not any(n in dev for n in LAYERS[layer]):
        return None
    return 1e3 * sum(dev.get(n, 0.0) for n in LAYERS[layer]) / spans["iters"]


def idle_in_iter_pct(spans: Dict):
    """The share of the stretch's device idle time that falls inside an
    iteration (``nfs.iter``): what a CUDA graph of the iteration can
    reach. None without iterations or idle time."""
    if not spans["iters"] or not spans["idle_total_s"]:
        return None
    return 100.0 * spans["idle_in_iter_s"] / spans["idle_total_s"]


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = harness.parse_args(argv)
    args.trace = 1
    cell = harness.load_cell(args.workload)
    harness.require_cards(cell.chips)
    import torch
    from torch.profiler import ProfilerActivity

    captured, walls = {}, {}
    read, trace = harness._events, harness.trace

    def capture(prof):
        if ProfilerActivity.CPU in prof.activities:
            captured["events"] = raw_events(prof)
        return read(prof)

    def timed_trace(step, activities, device):
        events, wall = trace(step, activities, device)
        key = ("host_pass_s" if ProfilerActivity.CPU in activities
               else "device_pass_s")
        walls[key] = wall
        return events, wall

    harness._events, harness.trace = capture, timed_trace
    out = harness.kind_module(cell).run(cell, args, t0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = harness.result(cell, out, True, torch.cuda.get_device_name(0),
                          cell.chips, harness.power_limit())
    s = reduce(captured["events"])
    metrics = {f"{k}_ms_per_iter": layer_ms_per_iter(s, k) for k in LAYERS}
    metrics["idle_in_iter_pct"] = idle_in_iter_pct(s)
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "walls": walls, "metrics": metrics, "spans": s,
                      "line": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
