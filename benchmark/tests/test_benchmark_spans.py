"""CPU tests of ``benchmark/spans.py``. On a synthetic trace: a forward
launch inside ``nfs.render``, its backward launched on autograd's thread
and linked to it by ``sequence_nr`` (an earlier operator in ``nfs.adam``
recording the same number without making the node), a launch on that
thread outside any node, a copy and a synchronizing call outside every
span, and idle gaps inside and outside ``nfs.iter``; the attribution
conserves the device time and the idle time that
``harness.reduce_events`` counts on the same events. On a real CPU trace
of the program's spans, each backward operator goes to the span of its
forward."""

import pytest

from benchmark import harness, spans
from benchmark.spans import Event

MAIN, AUTOGRAD = 1, 2


def _trace():
    def host(name, s, e, thread=MAIN, corr=0, seq=-1, fwd=0):
        return Event(name, False, s, e, thread, corr, seq, fwd)

    def dev(name, s, e, corr):
        return Event(name, True, s, e, 0, corr, -1, 0)

    return [
        host("nfs.iter", 0, 100),
        # an operator that records the sequence number the next node
        # takes without making it
        host("nfs.adam", 1, 5),
        host("aten::mul", 2, 3, seq=5),
        host("nfs.render", 10, 30),
        host("aten::mm", 12, 20, seq=5),
        host("cudaLaunchKernel", 13, 14, corr=100),
        dev("gemm_fwd", 15, 25, 100),
        host("nfs.backward", 40, 90),
        host("autograd::engine::evaluate_function: MmBackward0", 50, 70,
             thread=AUTOGRAD, seq=5, fwd=MAIN),
        host("aten::mm", 52, 68, thread=AUTOGRAD),
        host("cudaLaunchKernel", 55, 56, thread=AUTOGRAD, corr=200),
        dev("gemm_bwd", 60, 80, 200),
        host("cudaLaunchKernel", 85, 86, thread=AUTOGRAD, corr=210),
        dev("elementwise_accumulate", 86, 88, 210),
        host("cudaStreamSynchronize", 150, 160, corr=300),
        host("cudaMemcpyAsync", 165, 166, corr=310),
        dev("Memcpy DtoH", 170, 175, 310),
    ]


def test_kernels_launches_and_idle_go_to_their_spans():
    s = spans.reduce(_trace())
    assert s["iters"] == 1
    # forward 10 us plus its backward 20 us, launched on autograd's thread
    assert s["device_s"] == pytest.approx(
        {"nfs.render": 30e-6, "nfs.backward": 2e-6, "unspanned": 5e-6})
    by_cat = s["device_by_category_s"]
    assert sorted(by_cat) == ["nfs.backward", "nfs.render", "unspanned"]
    assert by_cat["nfs.render"] == pytest.approx({"gemm": 30e-6})
    assert by_cat["nfs.backward"] == pytest.approx({"elementwise": 2e-6})
    assert by_cat["unspanned"] == pytest.approx({"elementwise": 5e-6})
    assert s["launches"] == {"nfs.render": 2, "nfs.backward": 1}
    assert s["syncs"] == {"unspanned": 1}
    # gaps 25-60 and 80-86 while the main thread waits in nfs.backward,
    # 88-170 after the iteration
    assert s["idle_s"] == pytest.approx(
        {"nfs.backward": 41e-6, "unspanned": 82e-6})
    assert s["idle_in_iter_s"] == pytest.approx(41e-6)
    assert s["idle_total_s"] == pytest.approx(123e-6)
    assert spans.layer_ms_per_iter(s, "render") == pytest.approx(0.030)
    assert spans.layer_ms_per_iter(s, "splat") is None
    assert spans.idle_in_iter_pct(s) == pytest.approx(100 * 41 / 123)


def test_attribution_conserves_the_harness_totals():
    events = _trace()
    plain = [(e.name, e.device, e.start, e.end) for e in events]
    summary = harness.reduce_events(plain, 1e-3, 1, 1)
    s = spans.reduce(events)
    assert sum(s["device_s"].values()) == pytest.approx(
        sum(summary["device_s"].values()))
    assert s["idle_total_s"] == pytest.approx(
        sum(v for _, v in summary["idle_gaps"]))


def test_a_trace_without_spans_is_all_unspanned():
    events = [e for e in _trace() if not e.name.startswith("nfs.")]
    s = spans.reduce(events)
    assert s["iters"] == 0
    assert s["device_s"] == pytest.approx({"unspanned": 37e-6})
    assert s["launches"] == {"unspanned": 3}
    assert spans.layer_ms_per_iter(s, "render") is None
    assert spans.idle_in_iter_pct(s) is None


def test_backward_goes_to_its_forward_span_on_a_real_trace():
    """A CPU trace of the program's spans around a small forward and
    backward; each backward operator stands in for a kernel launch. The
    operator in ``nfs.adam`` records the sequence number of the next node
    without making it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nfs_tpu_torch.utils.profiling import span

    x = torch.randn(8, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("nfs.iter"):
            with span("nfs.adam"):
                x.detach() * 2.0
            with span("nfs.render"):
                y = x @ x
            with span("nfs.features"):
                loss = y.sin().sum()
            with span("nfs.backward"):
                torch.autograd.grad(loss, x)
    events = spans.raw_events(prof)
    stand_in = {"aten::mm": "gemm_bwd", "aten::cos": "sin_bwd"}
    nodes = [e for e in events if e.name.startswith(spans.NODE)]
    extra, corr = [], 10 ** 9
    for e in events:
        inside = any(n.thread == e.thread and n.start <= e.start <= n.end
                     for n in nodes)
        if inside and e.name in stand_in:
            corr += 1
            extra += [Event("cudaLaunchKernel", False, e.start, e.start,
                            e.thread, corr, -1, 0),
                      Event(stand_in[e.name], True, e.end, e.end + 1.0, 0,
                            corr, -1, 0)]
    s = spans.reduce(events + extra)
    assert s["device_by_category_s"]["nfs.render"]["gemm"] == pytest.approx(
        2e-6)
    assert s["device_s"]["nfs.features"] == pytest.approx(1e-6)
    assert "nfs.adam" not in s["device_s"]
