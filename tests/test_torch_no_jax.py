"""nfs_tpu_torch needs no JAX: a fresh interpreter in which any import of
``jax`` fails imports every module of the port and reads every name its
packages export, then runs the CLIs on
the CPU at a tiny size: the scene CLI (a 3D smoke, a 3D liquid and a 2D
smoke), grid mode (a single frame, a 2-frame window sequence, the same
frames jointly with ``--parallel``, a fused
3-frame sequence over the scene's smoke, run twice: the rerun resumes
from its manifest, and a 2D window sequence coloured by a transfer
function with in-frame checkpoints), particle mode (3 frames,
keyframes 0 and 2, density and colour), then a grid job and a
``"parallel"`` particle job (the keyframe-parallel engine) through the
stylization service (``cli.serve``) and ``cli.render`` over the grid
job's output."""

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
    for name in ["nfs_tpu_torch"] + names:  # every package export resolves
        module = sys.modules[name]
        for export in getattr(module, "__all__", ()):
            getattr(module, export)
    for name in ("eval.quality", "utils.flops", "utils.profiling",
                 "utils.metrics", "cli.serve", "cli.render",
                 "parallel.engine", "parallel.mesh", "parallel.sharding",
                 "parallel.multihost", "parallel.particles",
                 "parallel.spatial"):
        assert "nfs_tpu_torch." + name in names, name
    from nfs_tpu_torch.cli import scene
    from nfs_tpu_torch.cli.stylize import main
    data, log = sys.argv[1], sys.argv[2]
    for name, res in (("smoke3d", ["12", "10", "12"]),
                      ("liquid3d", ["8", "8", "8"]),
                      ("smoke2d", ["24", "16"])):
        scene.main(["--scene", name, "--out", log + "/" + name, "--res",
                    *res, "--frames", "3", "--device", "cpu"])
    common = ["--data_dir", data, "--log_dir", log, "--device", "cpu",
              "--render_size", "32", "32", "--n_views", "2",
              "--octave_n", "2", "--octave_scale", "2.0", "--iter", "2",
              "--style_layer", "relu1_1",
              "--style_target", data + "/style.npy"]
    main(common + ["--tag", "single"])
    main(common + ["--tag", "seq", "--num_frames", "2", "--window", "1",
                   "--parameterization", "velocity"])
    main(common + ["--tag", "par", "--num_frames", "2", "--window", "1",
                   "--parallel"])
    main(common + ["--tag", "lnst", "--mode", "particle", "--num_frames",
                   "3", "--keyframe_stride", "2", "--opt_density",
                   "--grid_shape", "12", "10", "12"])
    main(common + ["--tag", "color", "--mode", "particle", "--num_frames",
                   "3", "--keyframe_stride", "2", "--opt_color",
                   "--grid_shape", "12", "10", "12"])
    two_d = [a if a != data else log + "/smoke2d" for a in common]
    main(two_d + ["--tag", "grid2d", "--num_frames", "2", "--window", "1",
                  "--transfer_fn", "fire", "--checkpoint_in_frame"])
    fused = [a if a != data else log + "/smoke3d" for a in common]
    for _ in range(2):
        main(fused + ["--tag", "fused", "--num_frames", "3", "--window",
                      "1", "--fused", "2"])
    from nfs_tpu_torch.cli import render, serve
    spool = log + "/spool"
    serve.submit_job(spool, {
        "mode": "grid", "data_dir": data, "out_dir": log + "/served",
        "frames": [0], "style_target": data + "/style.npy",
        "config": {"render.render_size": [32, 32], "render.n_views": 2,
                   "loss.style_layers": ["relu1_1"],
                   "loss.style_layer_weights": [1.0],
                   "optim.octave_n": 1, "optim.iters": 2}}, name="job")
    serve.submit_job(spool, {
        "mode": "particle", "data_dir": data, "out_dir": log + "/pserved",
        "frames": [0, 1, 2], "parallel": True, "grid_shape": [12, 10, 12],
        "style_target": data + "/style.npy",
        "config": {"render.render_size": [32, 32], "render.n_views": 2,
                   "loss.style_layers": ["relu1_1"],
                   "loss.style_layer_weights": [1.0],
                   "optim.octave_n": 2, "optim.iters": 2,
                   "particle.optimize_density": True,
                   "particle.keyframe_stride": 2}}, name="pjob")
    serve.main(["--spool", spool, "--max_jobs", "2", "--poll", "0.01",
                "--device", "cpu"])
    render.main(["--data_dir", log + "/served", "--render_size", "32",
                 "32", "--device", "cpu"])
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
    for t in range(3):
        store.save_particles(t, x=(rng.random((300, 3)) * 8 + 2).astype(
            np.float32))
    np.save(data / "style.npy", rng.random((32, 32, 3), dtype=np.float32))

    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(data), str(tmp_path / "log")],
        capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("MODULES")]
    assert line and line[0].endswith("JAX_PACKAGE []"), proc.stdout
    assert int(line[0].split()[1]) >= 20

    smoke3d = FrameStore(str(tmp_path / "log" / "smoke3d"))
    assert smoke3d.load_velocity(2).shape == shape + (3,)
    liquid = FrameStore(str(tmp_path / "log" / "liquid3d")).load_particles(2)
    assert liquid["x"].shape[1] == 3 and np.isfinite(liquid["x"]).all()
    fused = tmp_path / "log" / "fused"
    assert sorted(json.loads((fused / "manifest.json").read_text())) == [
        "0", "1", "2"]
    assert "all frames already stylized (manifest)" in proc.stdout
    assert np.isfinite(FrameStore(str(fused)).load_density(2)).all()

    out = FrameStore(str(tmp_path / "log" / "single"))
    d0 = out.load_density(0)
    assert d0.shape == shape and np.isfinite(d0).all() and d0.min() >= 0
    seq = tmp_path / "log" / "seq"
    for t in range(2):
        assert np.isfinite(FrameStore(str(seq)).load_density(t)).all()
        with np.load(seq / f"param_{t:04d}.npz") as z:
            assert z["param"].shape == shape + (3,)
    par = tmp_path / "log" / "par"
    for t in range(2):
        d = FrameStore(str(par)).load_density(t)
        assert d.shape == shape and np.isfinite(d).all() and d.min() >= 0
    (line,) = [json.loads(l) for l in (par / "metrics.jsonl").open()]
    assert line["mesh"] == {"frames": 1, "views": 1}
    metrics = [json.loads(l) for l in
               (tmp_path / "log" / "single" / "metrics.jsonl").open()]
    assert metrics[0]["device"] == "cpu"
    lnst = tmp_path / "log" / "lnst"
    for t in range(3):
        p = FrameStore(str(lnst)).load_particles(t)
        assert p["x"].shape == (300, 3) and np.isfinite(p["x"]).all()
        assert p["dens"].shape == (300,) and (p["dens"] > 0).all()
        assert (lnst / f"preview_{t:04d}.png").exists()
    color = FrameStore(str(tmp_path / "log" / "color"))
    for t in range(3):
        p = color.load_particles(t)
        assert p["color"].shape == (300, 3) and np.isfinite(p["color"]).all()
    grid2d = tmp_path / "log" / "grid2d"
    for t in range(2):
        d = FrameStore(str(grid2d)).load_density(t)
        assert d.shape == (24, 16) and np.isfinite(d).all()
        assert (grid2d / f"preview_{t:04d}.png").exists()
    assert not (grid2d / "inframe_ckpt.npz").exists()
    for job in ("job", "pjob"):
        with open(tmp_path / "log" / "spool" / "done" / f"{job}.json") as f:
            assert json.load(f)["status"] == "ok"
    pserved = FrameStore(str(tmp_path / "log" / "pserved"))
    for t in range(3):
        p = pserved.load_particles(t)
        assert p["x"].shape == (300, 3) and np.isfinite(p["x"]).all()
    served = tmp_path / "log" / "served"
    d = FrameStore(str(served)).load_density(0)
    assert d.shape == shape and np.isfinite(d).all()
    assert [p.name for p in (served / "render").iterdir()
            if p.name.startswith("frame_0000.png")]
    overflow = [json.loads(l)["splat_overflow"]
                for l in (lnst / "metrics.jsonl").open()]
    # keyframes 0 and 2 log their parked particles per octave
    assert overflow[0] == overflow[2] == [0, 0] and overflow[1] is None
