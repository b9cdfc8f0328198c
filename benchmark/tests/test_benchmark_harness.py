"""CPU tests of the benchmark's yardstick: the inputs, the counts, the
cell files, the result line and the import check."""

import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import harness, inputs
from benchmark.roofline import counts

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_inputs_repeat_for_a_seed_and_differ_across_seeds():
    shape = (8, 6, 8)
    a = inputs.plume_density(shape, 3, 2 ** 31 + 11, 0, device="cpu")
    b = inputs.plume_density(shape, 3, 2 ** 31 + 11, 0, device="cpu")
    c = inputs.plume_density(shape, 3, 2 ** 31 + 12, 0, device="cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    w1 = inputs.vgg_weights(5, ["relu1_1", "relu4_1"], device="cpu")
    w2 = inputs.vgg_weights(5, ["relu4_1"], device="cpu")
    assert sorted(w1) == sorted(w2) and len(w1) == 9
    assert all(torch.equal(w1[k]["w"], w2[k]["w"]) for k in w1)
    s1 = inputs.view_schedule(7, 0, 4, 3, 20, 3, 32)
    assert np.array_equal(s1, inputs.view_schedule(7, 0, 4, 3, 20, 3, 32))
    assert s1.min() >= 0 and s1.max() < 32


def test_swirl_is_capped_and_the_plume_stays_in_the_grid():
    v = inputs.swirl_velocity((16, 8, 16), 40, 1.5, device="cpu")
    assert float(torch.linalg.vector_norm(v, dim=-1).max()) <= 1.5 + 1e-5
    d = inputs.plume_density((16, 8, 16), 200, 3, 0, device="cpu")
    # the blob's drift is periodic: frame 64 is frame 0's blob again
    assert torch.allclose(d[64] / d[0], torch.ones(()), atol=0.21)


def test_vgg_layer_flops_match_a_hand_count():
    # conv1_1 on 256^2: 2 * 65536 cells * 9 taps * 3 in * 64 out
    assert counts.vgg_forward_flops(256, 256, "relu1_1") == (
        2 * 65536 * 9 * 3 * 64)
    # relu2_1 adds conv1_2 at 256^2 and conv2_1 at 128^2
    assert counts.vgg_forward_flops(256, 256, "relu2_1") == (
        2 * 65536 * 9 * (3 * 64 + 64 * 64) + 2 * 16384 * 9 * 64 * 128)


def test_advection_bytes_match_a_hand_count():
    # K1 at 112x64x112 reads the field and a 3-vector, writes the field:
    # 5 floats a cell, 16.06 MB, 4.79 us at 3.35 TB/s
    n = 112 * 64 * 112
    assert counts.advect_least_s("fwd", n) == pytest.approx(
        20 * n / 3.35e12)
    assert counts.advect_least_s("fwd", n) * 1e6 == pytest.approx(
        4.79, abs=0.01)


def test_shear_flops_count_six_dense_shears():
    z, y, x = 10, 6, 8
    want = 4 * (2 * z * z * y * x) + 2 * x * x * z * y + 2 * y * y * z * x
    assert counts.shear_rotate_flops((z, y, x)) == want


def test_every_cell_names_existing_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["name"] == w["config"]
        mix = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "kinds" / f"{mix['kind']}.py").exists()
        cell = harness.load_cell(w["name"], BENCH)
        assert cell.per_layer and cell.end_to_end
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        base = m["name"].split(".")[0]
        assert (ROOT / "benchmark" / "metrics" / f"{base}.py").exists()
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        # every cell the metric is read in reports the metric it moves
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells)), m["name"]
    for w in cells:     # each cell: setup_s, another end-to-end metric
        got = {e for e, v in e2e.items() if w in v.get("workloads", cells)}
        assert "setup_s" in got and len(got) >= 2, w


def test_result_line_has_the_contract_keys_and_checks_last():
    cell = harness.load_cell(BENCH["workloads"][0]["name"], BENCH)
    out = harness.Outcome(frames=20, window_s=30.0, setup_s=12.0,
                          peak_bytes=2 ** 32,
                          checks=[harness.Check("cold_gap", 0.01, 0.1)])
    line = harness.result(cell, out, False, "NVIDIA H100 80GB HBM3", 1,
                          "card")
    assert line["correct"] is True
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "card", "checks"}
    assert list(line)[-1] == "checks"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {"s_per_frame", "peak_mem_gib",
                                    "setup_s"}
    assert line["metrics"]["s_per_frame"]["value"] == 1.5
    bad = harness.Outcome(frames=20, window_s=30.0, setup_s=12.0,
                          peak_bytes=1,
                          checks=[harness.Check("cold_gap", math.nan, 0.1)])
    assert harness.result(cell, bad, False, "x", 1, "c")["correct"] is False
    joint = harness.load_cell("tnst3d.joint16", BENCH)
    assert set(harness.result(joint, out, False, "x", 1, "c")["metrics"]) \
        == {"s_per_frame.joint", "peak_mem_gib", "setup_s"}
    # one reader serves both splits, and finds its numbers by name
    assert harness.result(joint, out, False, "x", 1, "c")["metrics"][
        "s_per_frame.joint"]["value"] == 1.5
    empty = harness.Outcome(frames=0, window_s=30.0, setup_s=12.0,
                            peak_bytes=1)
    with pytest.raises(RuntimeError):
        harness.result(cell, empty, False, "x", 1, "c")


def test_trace_reduction_takes_the_union_and_names_gaps():
    ev = [("aten::mul", False, 0.0, 10.0),
          ("cudaLaunchKernel", False, 1.0, 2.0),
          ("cudaLaunchKernel", False, 3.0, 4.0),
          ("elementwise_kernel", True, 5.0, 9.0),
          ("sm90_gemm", True, 7.0, 12.0),
          ("aten::cat", False, 12.0, 30.0),
          ("advect_fwd_kernel", True, 20.0, 22.0)]
    s = harness.reduce_events(ev, wall_s=40e-6, iters=2, frames=1)
    assert s["busy_s"] == pytest.approx(9e-6)
    assert s["launches"] == 2
    assert s["device_s"]["gemm"] == pytest.approx(5e-6)
    assert s["idle_gaps"][0] == ["aten::cat", pytest.approx(8e-6)]
    from benchmark.metrics import device_idle_pct, host_launches_per_iter
    # busy and wall both of the traced stretch, unclipped
    assert device_idle_pct.read(s) == pytest.approx(100 * (1 - 9 / 40))
    s["window_s"] = 6e-6
    assert device_idle_pct.read(s) == pytest.approx(100 * (1 - 9 / 6))
    assert host_launches_per_iter.read(s) == 1.0


def test_a_reader_with_nothing_to_read_returns_none():
    from benchmark.metrics import transport_roofline_pct
    assert transport_roofline_pct.read({"device_s": {}}) is None


def test_the_import_check_compares_top_level_names_whole():
    assert harness.forbidden_modules(
        ["nfs_tpu_torch", "nfs_tpu_torch.ops", "numpy"]) == []
    assert harness.forbidden_modules(
        ["nfs_tpu.styler", "jaxlib.xla_client", "jaxtyping"]) == [
            "jaxlib", "nfs_tpu"]


def test_the_benchmark_never_imports_jax_or_the_jax_package():
    src = ROOT / "benchmark"
    for f in src.rglob("*.py"):
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                top = words[1].split(".")[0].rstrip(",")
                assert top not in harness.FORBIDDEN, (f, line)
                if "reference" in f.parts:
                    assert top != "nfs_tpu_torch", (f, line)
        if "tests" not in f.parts:
            # names bench.py or a path under bench/ as a string to open
            assert not re.search(r"(?<![\w/])bench\.py|[\"']bench/",
                                 f.read_text()), f


def test_the_command_fails_without_a_card_and_prints_no_result():
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
