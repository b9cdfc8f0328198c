"""nfs_tpu_torch needs no JAX: a fresh interpreter in which any import of
``jax`` fails imports every module of the port, then runs the grid CLI on
the CPU (a single frame and a 2-frame window sequence) at a tiny size."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import torch
    torch.set_num_threads(2)
    import nfs_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        nfs_tpu_torch.__path__, "nfs_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from nfs_tpu_torch.cli.stylize import main
    data, log = sys.argv[1], sys.argv[2]
    common = ["--data_dir", data, "--log_dir", log, "--device", "cpu",
              "--render_size", "32", "32", "--n_views", "2",
              "--octave_n", "2", "--octave_scale", "2.0", "--iter", "2",
              "--style_layer", "relu1_1",
              "--style_target", data + "/style.npy"]
    main(common + ["--tag", "single"])
    main(common + ["--tag", "seq", "--num_frames", "2", "--window", "1",
                   "--parameterization", "velocity"])
    bad = sorted(m for m in sys.modules
                 if m == "nfs_tpu" or m.startswith("nfs_tpu."))
    print("MODULES", len(names), "JAX_PACKAGE", bad)
""")


def test_port_imports_and_cli_run_without_jax(tmp_path):
    from nfs_tpu_torch.io.npz import FrameStore

    data = tmp_path / "data"
    store = FrameStore(str(data))
    rng = np.random.default_rng(0)
    shape = (12, 10, 12)
    for t in range(2):
        store.save_density(t, rng.random(shape, dtype=np.float32))
        store.save_velocity(t, 0.5 * rng.standard_normal(
            shape + (3,)).astype(np.float32))
    np.save(data / "style.npy", rng.random((32, 32, 3), dtype=np.float32))

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(data), str(tmp_path / "log")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("MODULES")]
    assert line and line[0].endswith("JAX_PACKAGE []"), proc.stdout
    assert int(line[0].split()[1]) >= 20

    out = FrameStore(str(tmp_path / "log" / "single"))
    d0 = out.load_density(0)
    assert d0.shape == shape and np.isfinite(d0).all() and d0.min() >= 0
    seq = tmp_path / "log" / "seq"
    for t in range(2):
        assert np.isfinite(FrameStore(str(seq)).load_density(t)).all()
        with np.load(seq / f"param_{t:04d}.npz") as z:
            assert z["param"].shape == shape + (3,)
    metrics = [json.loads(l) for l in
               (tmp_path / "log" / "single" / "metrics.jsonl").open()]
    assert metrics[0]["device"] == "cpu"
