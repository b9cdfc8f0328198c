"""nfs_tpu_torch's observability utils on the CPU: ``MetricsLogger``,
``IterationTimer`` and ``timed``, a ``trace`` that writes a Chrome trace
file, and every function and constant of ``utils/flops.py`` equal to the
JAX package's (the TPU constants included), ``mfu`` defaulting to the
H100's dense bf16 peak."""

import json
import os

import pytest
import torch

from nfs_tpu.utils import flops as jflops
from nfs_tpu_torch.utils import IterationTimer, MetricsLogger, timed, trace
from nfs_tpu_torch.utils import flops

torch.set_num_threads(2)

LAYERS = [("relu1_1",), ("relu3_1", "relu1_1"), ("relu4_1",),
          ("relu5_4",), ()]


def test_metrics_log_and_read(tmp_path):
    path = str(tmp_path / "sub" / "m.jsonl")
    m = MetricsLogger(path, tag="t1")
    m.log(frame=0, loss=0.5)
    m.log(frame=1, loss=0.25, iters_per_sec=80.0)
    recs = m.read()
    assert len(recs) == 2
    assert recs[0]["tag"] == "t1"
    assert recs[1]["iters_per_sec"] == 80.0
    assert all("t" in r for r in recs)
    assert MetricsLogger(str(tmp_path / "none.jsonl")).read() == []


def test_iteration_timer_and_timed_on_cpu():
    t = IterationTimer(device="cpu")
    for _ in range(3):
        with t:
            torch.ones(64, 64).sum()
    assert len(t.times_ms) == 3
    assert t.mean_ms > 0.0 and t.last_ms > 0.0
    ms, out = timed(lambda x: x * 2 + 1, torch.ones(128, 128), n=3,
                    device="cpu")
    assert ms >= 0.0
    assert torch.equal(out, torch.full((128, 128), 3.0))


def test_timers_synchronize_the_cuda_device(monkeypatch):
    """On a CUDA device both timers wait for the device (JAX's
    effects_barrier / block_until_ready)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    with IterationTimer(device="cuda"):
        pass
    timed(lambda: None, n=2, device="cuda:0")
    assert synced == [torch.device("cuda"), torch.device("cuda:0"),
                      torch.device("cuda:0")]


def test_trace_writes_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)) as prof:
        torch.ones(32, 32).matmul(torch.ones(32, 32))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)
    assert prof.key_averages()


def test_trace_raises_when_the_profiler_fails(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with trace(str(tmp_path / "t")):
            pass


def test_constants_match_jax():
    assert flops.TPU_V5E_PEAK_BF16 == jflops.TPU_V5E_PEAK_BF16
    assert flops.TPU_V5E_PEAK_F32 == jflops.TPU_V5E_PEAK_F32
    # the H100 SXM5's dense peaks (NVIDIA datasheet, not the sparse ones)
    assert flops.H100_SXM_PEAK_BF16 == 989.4e12
    assert flops.H100_SXM_PEAK_F32 == 66.9e12


@pytest.mark.parametrize("layers", LAYERS)
@pytest.mark.parametrize("hw", [(224, 224), (256, 192), (31, 17)])
def test_vgg_forward_flops_match_jax(layers, hw):
    assert (flops.vgg_forward_flops(*hw, layers)
            == jflops.vgg_forward_flops(*hw, layers))


@pytest.mark.parametrize("shape", [(64, 48, 64), (112, 64, 112)])
def test_render_and_step_flops_match_jax(shape):
    assert flops.shear_rotate_flops(shape) == jflops.shear_rotate_flops(shape)
    assert (flops.render_forward_flops(shape, (256, 256), 9)
            == jflops.render_forward_flops(shape, (256, 256), 9))
    for layers in LAYERS:
        for renders in (1, 3):
            assert (flops.styler_step_flops(shape, (128, 96), 4, layers,
                                            n_window_renders=renders)
                    == jflops.styler_step_flops(shape, (128, 96), 4, layers,
                                                n_window_renders=renders))


def test_mfu_defaults_to_the_h100_bf16_peak():
    assert flops.mfu(flops.H100_SXM_PEAK_BF16) == 1.0
    assert abs(flops.mfu(98.94e12) - 0.1) < 1e-12
    assert (flops.mfu(19.7e12, peak=flops.TPU_V5E_PEAK_BF16)
            == jflops.mfu(19.7e12))
