"""The port's CLIs: the stylization CLI runs grid and particle mode,
``--parallel`` grid sequences (in this process against the JAX CLI, and
on two gloo ranks under ``torchrun``), ``--parallel --mode particle``
(against the JAX CLI, and on two gloo ranks), and takes the mesh flags
into ``cfg.parallel``; the transfer function, particle colour
and in-frame checkpoint flags run; a fused grid sequence resumes from its
manifest. The scene CLI writes the frames of the JAX package's
solvers."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nfs_tpu.cli import stylize as jax_stylize
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params, save_vgg_params
from nfs_tpu.io.uni import read_uni as jax_read_uni
from nfs_tpu.utils import profiling as jax_profiling
from nfs_tpu.sim import flip as jax_flip
from nfs_tpu.sim import smoke as jax_smoke
from nfs_tpu_torch.cli import scene
from nfs_tpu_torch.cli import stylize as torch_stylize
from nfs_tpu_torch.cli.stylize import build_parser, main
from nfs_tpu_torch.core.config import replace
from nfs_tpu_torch.io.image import save_image
from nfs_tpu_torch.io.npz import FrameStore

torch.set_num_threads(2)


@pytest.mark.parametrize("argv", [
    ["--num_frames", "3"],      # keyframes 0 and 2 through the engine
    [],                         # one frame: nothing to run in parallel
], ids=["three frames", "default frames"])
def test_parallel_particle_mode_matches_jax_cli(argv, tmp_path,
                                                monkeypatch, capsys):
    """``--parallel --mode particle`` through both CLIs with one view
    (render.view_pool 1) and one VGG weights file: over 3 frames the
    port's ParallelKeyframeStyler on its (1, 1) mesh and JAX's on its
    default mesh of the 8 virtual devices (it pads the 2 keyframes), over
    the default single frame both CLIs' sequential path; every written
    frame within the engines' parity tolerance (rtol 4e-3, atol 4e-4;
    positions as offsets from the input frame), with a preview."""
    monkeypatch.setattr(jax_profiling, "enable_compile_cache",
                        lambda *a, **k: None)
    for mod, rep in ((jax_stylize, jax_replace), (torch_stylize, replace)):
        orig = mod.config_from_args
        monkeypatch.setattr(
            mod, "config_from_args",
            lambda a, orig=orig, rep=rep: rep(orig(a),
                                              **{"render.view_pool": 1}))
    data = tmp_path / "data"
    store = FrameStore(str(data))
    rng = np.random.default_rng(7)
    x0 = rng.random((300, 3)) * 8 + 2
    for t in range(3):
        store.save_particles(t, x=(x0 + 0.2 * t).astype(np.float32))
    save_image(str(data / "style.png"), np.random.default_rng(0).random(
        (32, 32, 3), dtype=np.float32))
    save_vgg_params(str(data / "vgg.npz"), init_vgg_params(0))
    flags = COMMON[2:] + [
        "--data_dir", str(data), "--log_dir", str(tmp_path), "--mode",
        "particle", "--parallel", "--keyframe_stride", "2", "--opt_density",
        "--grid_shape", "12", "12", "12", "--w_style", "1000",
        "--style_target", str(data / "style.png"), "--vgg_weights",
        str(data / "vgg.npz")] + argv
    jax_stylize.main(flags + ["--tag", "jax"])
    main(flags + ["--tag", "torch", "--device", "cpu"])
    parallel = bool(argv)
    assert ("[parallel] 3 particle frames, keyframes [0, 2] on mesh "
            "{'frames': 1, 'views': 1}" in capsys.readouterr().out) == parallel
    n_frames = 3 if parallel else 1
    moved = 0.0
    for t in range(n_frames):
        j = FrameStore(str(tmp_path / "jax")).load_particles(t)
        p = FrameStore(str(tmp_path / "torch")).load_particles(t)
        # positions as offsets from the input frame
        x_in = (x0 + 0.2 * t).astype(np.float32)
        np.testing.assert_allclose(p["x"] - x_in, j["x"] - x_in,
                                   rtol=4e-3, atol=4e-4)
        np.testing.assert_allclose(p["dens"], j["dens"], rtol=4e-3,
                                   atol=4e-4)
        moved = max(moved, float(np.abs(p["x"] - x_in).max()))
        assert (tmp_path / "torch" / f"preview_{t:04d}.png").exists() or (
            tmp_path / "torch" / f"preview_{t:04d}.png.npy").exists()
    assert moved > 1e-5
    assert not (tmp_path / "torch" / f"p_{n_frames:04d}.npz").exists()
    with open(tmp_path / "torch" / "metrics.jsonl") as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == n_frames
    assert ("mesh" in lines[0]) == parallel


@pytest.mark.parametrize("argv, field, value", [
    (["--mesh_views", "2"], "parallel.views", 2),
    (["--train_transfer"], "render.train_transfer", True),
    (["--mesh_frames", "2"], "parallel.frames", 2),
    (["--transfer_fn", "fire"], "render.transfer_fn", "fire"),
])
def test_particle_mesh_and_transfer_flags_absent(argv, field, value):
    """The mesh flags reach ``cfg.parallel`` as the JAX CLI puts them
    there (the halo depth is --window; an absent flag is an axis of 1);
    the transfer-function flags reach the render config."""
    from nfs_tpu_torch.cli.stylize import config_from_args

    args = argv + ["--tf_max_density", "1.5", "--window", "2"]
    cfg = config_from_args(build_parser().parse_args(args))
    jcfg = jax_stylize.config_from_args(
        jax_stylize.build_parser().parse_args(args))
    group, name = field.split(".")
    assert getattr(getattr(cfg, group), name) == value
    assert cfg.render.tf_max_density == 1.5
    assert vars(cfg.parallel) == vars(jcfg.parallel)
    assert cfg.parallel.halo == 2


def test_particle_flags_reach_the_config():
    from nfs_tpu_torch.cli.stylize import config_from_args

    args = build_parser().parse_args(
        ["--mode", "particle", "--no_opt_position", "--opt_density",
         "--keyframe_stride", "4", "--max_log_dens", "2.0",
         "--grid_shape", "8", "9", "10", "--p_path", "q_%04d.npz"])
    cfg = config_from_args(args)
    pc = cfg.particle
    assert (pc.optimize_position, pc.optimize_density, pc.optimize_color,
            pc.keyframe_stride, pc.max_log_dens) == (False, True, False, 4,
                                                     2.0)
    assert cfg.data.p_path == "q_%04d.npz"
    assert args.grid_shape == [8, 9, 10]


SCENES = {
    "smoke2d": (["--res", "20", "16"], 2),
    "smoke3d": (["--res", "12", "10", "12", "--uni"], 3),
    "liquid2d": (["--res", "20", "20"], 2),
    "liquid3d": (["--res", "10", "10", "10"], 3),
}


def _jax_scene(name, res, frames):
    """The JAX package's cli/scene.py configurations, run directly."""
    if name.startswith("smoke"):
        center = (0.85, 0.5) if name == "smoke2d" else (0.5, 0.85, 0.5)
        return jax_smoke.smoke_sequence(
            jax_smoke.SmokeConfig(shape=res, source_center=center), frames)
    nd = len(res)
    return jax_flip.liquid_sequence(
        jax_flip.FlipConfig(shape=res, block_lo=(0.05,) + (0.3,) * (nd - 1),
                            block_hi=(0.5,) + (0.7,) * (nd - 1)), frames)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_cli_writes_the_jax_scenes(name, tmp_path):
    flags, nd = SCENES[name]
    res = tuple(int(a) for a in flags[1:1 + nd])
    out = tmp_path / name
    scene.main(["--scene", name, "--out", str(out), "--frames", "2",
                "--device", "cpu"] + flags)
    want = _jax_scene(name, res, 2)
    store = FrameStore(str(out))
    for t in range(2):
        if name.startswith("smoke"):
            got = (store.load_density(t), store.load_velocity(t))
            # f32 sums in another order over 40 Jacobi sweeps
            tol = [1e-5 * float(np.abs(w[t]).max()) for w in want]
        else:
            p = store.load_particles(t)
            got = (p["x"], p["vel"])
            assert (p["dens"] == 1.0).all()
            tol = [1e-4, 1e-4]  # cells, as tests/test_torch_sim.py
        for g, w, a in zip(got, want, tol):
            np.testing.assert_allclose(g, w[t], atol=a)
    if "--uni" in flags:
        np.testing.assert_array_equal(
            jax_read_uni(str(out / "d_0001.uni"))[0], store.load_density(1))


def test_scene_cli_refuses_a_missing_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene.main(["--scene", "smoke2d", "--out", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


def _stylize(data, log, extra=()):
    main(["--data_dir", str(data), "--log_dir", str(log), "--tag", "seq",
          "--device", "cpu", "--render_size", "32", "32", "--n_views", "2",
          "--octave_n", "2", "--octave_scale", "2.0", "--iter", "2",
          "--style_layer", "relu1_1", "--style_target",
          str(data / "style.npy"), "--num_frames", "4", "--window", "1",
          "--fused", "2", *extra])


def test_fused_sequence_resumes_from_its_manifest(tmp_path, capsys):
    """--fused 2 saves the carry param at frames 1 and 3; a rerun with a
    complete manifest stylizes nothing; with frames 2-3 lost it resumes at
    frame 2 from param_0001 and velocity 1 and writes the same frames."""
    data = tmp_path / "data"
    scene.main(["--scene", "smoke3d", "--out", str(data), "--res", "12",
                "10", "12", "--frames", "4", "--device", "cpu"])
    np.save(data / "style.npy",
            np.random.default_rng(0).random((32, 32, 3), dtype=np.float32))
    log = tmp_path / "log"
    _stylize(data, log)
    seq = log / "seq"
    first = [FrameStore(str(seq)).load_density(t) for t in range(4)]
    assert sorted(p for p in os.listdir(seq) if p.startswith("param")) == [
        "param_0001.npz", "param_0003.npz"]
    manifest = json.loads((seq / "manifest.json").read_text())
    assert sorted(manifest) == ["0", "1", "2", "3"]

    capsys.readouterr()
    _stylize(data, log)
    assert "all frames already stylized (manifest)" in capsys.readouterr().out

    for t in (2, 3):
        os.unlink(seq / f"d_{t:04d}.npz")
    _stylize(data, log)
    out = capsys.readouterr().out
    assert "[frame 2]" in out and "[frame 1]" not in out
    for t in range(4):
        np.testing.assert_array_equal(
            FrameStore(str(seq)).load_density(t), first[t])


def _style(data, size=32):
    np.save(data / "style.npy", np.random.default_rng(0).random(
        (size, size, 3), dtype=np.float32))


COMMON = ["--device", "cpu", "--render_size", "32", "32", "--n_views", "2",
          "--octave_n", "2", "--octave_scale", "2.0", "--iter", "2",
          "--style_layer", "relu1_1"]


def test_opt_color_particle_mode_2d(tmp_path):
    """--opt_color on 2D liquid frames: every frame comes out with a
    colour per particle, optimized away from the 0.5 grey it starts at."""
    data = tmp_path / "data"
    scene.main(["--scene", "liquid2d", "--out", str(data), "--res", "20",
                "20", "--frames", "3", "--device", "cpu"])
    _style(data)
    main(COMMON + ["--data_dir", str(data), "--log_dir", str(tmp_path),
                   "--tag", "lnst", "--mode", "particle", "--opt_color",
                   "--opt_density", "--num_frames", "3",
                   "--keyframe_stride", "2", "--grid_shape", "20", "20",
                   "--w_style", "1000", "--style_target",
                   str(data / "style.npy")])
    out = FrameStore(str(tmp_path / "lnst"))
    for t in range(3):
        p = out.load_particles(t)
        n = p["x"].shape[0]
        assert p["x"].shape == (n, 2) and p["color"].shape == (n, 3)
        assert np.isfinite(p["color"]).all()
        assert np.abs(p["color"] - 0.5).max() > 1e-4
        assert (tmp_path / "lnst" / f"preview_{t:04d}.png").exists()


def test_transfer_flags_run_and_resume(tmp_path, capsys):
    """--transfer_fn with --train_transfer on 2D smoke: a single frame
    exports its trained nodes; a W=1 sequence saves the {field, tf}
    carry, and a rerun that lost frame 1 resumes from it and writes the
    same frame."""
    data = tmp_path / "data"
    scene.main(["--scene", "smoke2d", "--out", str(data), "--res", "24",
                "16", "--frames", "2", "--device", "cpu"])
    _style(data)
    flags = COMMON + ["--data_dir", str(data), "--log_dir", str(tmp_path),
                      "--transfer_fn", "fire", "--train_transfer",
                      "--tf_max_density", "1.0", "--w_style", "1000",
                      "--style_target", str(data / "style.npy")]
    main(flags + ["--tag", "frame"])
    from nfs_tpu_torch.render.transfer import COLORMAPS

    with np.load(tmp_path / "frame" / "tf_0000.npz") as z:
        nodes = z["nodes"]
    assert nodes.shape == (8, 3) and nodes.min() >= 0 and nodes.max() <= 1
    assert np.abs(nodes - COLORMAPS["fire"]).max() > 1e-4
    seq = tmp_path / "seq"
    main(flags + ["--tag", "seq", "--num_frames", "2", "--window", "1"])
    with np.load(seq / "param_0000.npz") as z:
        assert sorted(z.files) == ["param/field", "param/tf"]
        assert z["param/field"].shape == (24, 16)
    assert (seq / "tf_0001.npz").exists()
    first = FrameStore(str(seq)).load_density(1)
    os.unlink(seq / "d_0001.npz")
    capsys.readouterr()
    main(flags + ["--tag", "seq", "--num_frames", "2", "--window", "1"])
    out = capsys.readouterr().out
    assert "[frame 1]" in out and "[frame 0]" not in out
    np.testing.assert_array_equal(FrameStore(str(seq)).load_density(1),
                                  first)


def test_checkpoint_in_frame_fused_sequence(tmp_path):
    """--checkpoint_in_frame with --fused 2: the job completes, leaves no
    checkpoint and writes the frames of the same job without it."""
    data = tmp_path / "data"
    scene.main(["--scene", "smoke3d", "--out", str(data), "--res", "12",
                "10", "12", "--frames", "3", "--device", "cpu"])
    _style(data)
    flags = COMMON + ["--data_dir", str(data), "--log_dir", str(tmp_path),
                      "--num_frames", "3", "--window", "1", "--fused", "2",
                      "--style_target", str(data / "style.npy")]
    main(flags + ["--tag", "plain"])
    main(flags + ["--tag", "ck", "--checkpoint_in_frame"])
    assert not (tmp_path / "ck" / "inframe_ckpt.npz").exists()
    for t in range(3):
        np.testing.assert_array_equal(
            FrameStore(str(tmp_path / "ck")).load_density(t),
            FrameStore(str(tmp_path / "plain")).load_density(t))


def _parallel_inputs(tmp_path):
    """Two frames of a Gaussian plume (positive everywhere, as the serve
    parity's data) with random velocities, a style PNG and one VGG
    weights file. In cells of zero density the gradient is near zero
    and Adam's normalized step carries f32 rounding into whole steps:
    there the streaming styler too leaves JAX by ~4e-3 in 3 iterations."""
    data = tmp_path / "data"
    store = FrameStore(str(data))
    shape = (12, 10, 12)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    rng = np.random.default_rng(4)
    for t in range(2):
        store.save_density(t, (np.exp(-4 * sum(x ** 2 for x in g))
                               * (1 + 0.1 * t)).astype(np.float32))
        store.save_velocity(t, (0.5 * rng.standard_normal(
            shape + (3,))).astype(np.float32))
    save_image(str(data / "style.png"), np.random.default_rng(0).random(
        (32, 32, 3), dtype=np.float32))
    save_vgg_params(str(data / "vgg.npz"), init_vgg_params(0))
    return data, ["--data_dir", str(data), "--render_size", "32", "32",
                  "--n_views", "2", "--octave_n", "1", "--iter", "3",
                  "--style_layer", "relu1_1,relu2_1", "--w_style", "1000",
                  "--lr", "0.02", "--transmit", "0.5", "--num_frames", "2",
                  "--window", "1", "--style_target",
                  str(data / "style.png"), "--vgg_weights",
                  str(data / "vgg.npz"), "--parallel"]


def test_parallel_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """``--parallel`` through both CLIs with one view (render.view_pool
    1): the port on its (1, 1) mesh, JAX on mesh_shape_for of the 8
    virtual devices; every frame within 1e-3 (the serve parity's
    tolerance), a preview per frame and one metrics line."""
    monkeypatch.setattr(jax_profiling, "enable_compile_cache",
                        lambda *a, **k: None)
    for mod, rep in ((jax_stylize, jax_replace), (torch_stylize, replace)):
        orig = mod.config_from_args
        monkeypatch.setattr(
            mod, "config_from_args",
            lambda a, orig=orig, rep=rep: rep(orig(a),
                                              **{"render.view_pool": 1}))
    data, argv = _parallel_inputs(tmp_path)
    log = tmp_path / "log"
    jax_stylize.main(argv + ["--log_dir", str(log), "--tag", "jax"])
    main(argv + ["--log_dir", str(log), "--tag", "torch", "--device",
                 "cpu"])
    out = capsys.readouterr().out
    assert "[parallel] 2 frames" in out and "'frames': 1, 'views': 1" in out
    for t in range(2):
        j = FrameStore(str(log / "jax")).load_density(t)
        d = FrameStore(str(log / "torch")).load_density(t)
        assert d.shape == j.shape == (12, 10, 12)
        assert np.abs(d - j).max() <= 1e-3
        assert (log / "torch" / f"preview_{t:04d}.png").exists() or (
            log / "torch" / f"preview_{t:04d}.png.npy").exists()
    with open(log / "torch" / "metrics.jsonl") as f:
        (line,) = [json.loads(x) for x in f]
    assert line["frames"] == 2 and line["mesh"] == {"frames": 1,
                                                    "views": 1}
    assert np.isfinite(line["final_loss"])


def test_parallel_cli_on_two_gloo_ranks(tmp_path):
    """``torchrun --standalone`` with two ranks on the CPU (gloo), the
    frames split over them: rank 0 writes every frame, which equal the
    single-process run's."""
    data, argv = _parallel_inputs(tmp_path)
    log = tmp_path / "log"
    main(argv + ["--log_dir", str(log), "--tag", "one", "--device", "cpu"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "nfs_tpu_torch.cli.stylize", *argv,
         "--log_dir", str(log), "--tag", "two", "--device", "cpu",
         "--mesh_frames", "2"], env=env, capture_output=True, text=True,
        timeout=300, process_group=0)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("[parallel] 2 frames") == 1
    assert "'frames': 2, 'views': 1} of 2 rank(s)" in proc.stdout
    for t in range(2):
        np.testing.assert_allclose(
            FrameStore(str(log / "two")).load_density(t),
            FrameStore(str(log / "one")).load_density(t),
            rtol=1e-5, atol=1e-6)


def test_parallel_particle_cli_on_two_gloo_ranks(tmp_path):
    """``--parallel --mode particle`` under ``torchrun --standalone`` with
    two ranks on the CPU (gloo), keyframes 0, 2 and 4 split over them
    (padded to 4): rank 0 writes every frame, which equal the
    single-process run's."""
    data = tmp_path / "data"
    store = FrameStore(str(data))
    rng = np.random.default_rng(8)
    x0 = rng.random((250, 3)) * 8 + 2
    for t in range(5):
        store.save_particles(t, x=(x0 + 0.2 * t).astype(np.float32))
    _style(data)
    log = tmp_path / "log"
    argv = COMMON + ["--data_dir", str(data), "--log_dir", str(log),
                     "--mode", "particle", "--parallel", "--num_frames",
                     "5", "--keyframe_stride", "2", "--opt_density",
                     "--grid_shape", "12", "12", "12", "--style_target",
                     str(data / "style.npy")]
    main(argv + ["--tag", "one"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "nfs_tpu_torch.cli.stylize", *argv,
         "--tag", "two", "--mesh_frames", "2"], env=env,
        capture_output=True, text=True, timeout=300, process_group=0)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("[parallel] 5 particle frames, keyframes "
                             "[0, 2, 4] on mesh {'frames': 2, 'views': 1} "
                             "of 2 rank(s)") == 1
    for t in range(5):
        two = FrameStore(str(log / "two")).load_particles(t)
        one = FrameStore(str(log / "one")).load_particles(t)
        for k in ("x", "dens"):
            np.testing.assert_allclose(two[k], one[k], rtol=1e-5, atol=1e-6)
