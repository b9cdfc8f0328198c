"""nfs_tpu_torch's stylization service (``cli/serve.py``) on the CPU: the
cases of tests/test_serve.py (spool protocol, styler and frame caches,
error isolation), ``"parallel"`` jobs (a grid one and a particle one
through both packages' workers), and the same 2D and 3D jobs through the
JAX package's worker and the port's, which share one VGG weights file.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from nfs_tpu.cli.serve import StylizeWorker as JaxStylizeWorker
from nfs_tpu.features.vgg import init_vgg_params, save_vgg_params
from nfs_tpu_torch.cli.serve import (
    StylizeWorker, _config_from_job, serve, submit_job)
from nfs_tpu_torch.io.image import save_image

torch.set_num_threads(2)


def _make_data(data_dir, T=2, shape=(16, 12)):
    os.makedirs(data_dir, exist_ok=True)
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    d0 = np.exp(-4 * sum(x ** 2 for x in g)).astype(np.float32)
    for t in range(T):
        np.savez(os.path.join(data_dir, f"d_{t:04d}.npz"),
                 d=d0 * (1 + 0.1 * t))


def _style_png(path):
    rng = np.random.default_rng(0)
    save_image(path, rng.random((32, 32, 3)).astype(np.float32))


def _job(data_dir, out_dir, style, frames=(0,)):
    return {
        "mode": "grid",
        "data_dir": data_dir,
        "out_dir": out_dir,
        "frames": list(frames),
        "style_target": style,
        "config": {
            "render.render_size": (32, 32),
            "render.n_views": 2,
            "loss.style_layers": ["relu1_1"],
            "loss.style_layer_weights": [1.0],
            "optim.octave_n": 1,
            "optim.iters": 2,
        },
    }


def _serve(spool, **kw):
    return serve(spool, poll_s=0.01, device="cpu", **kw)


def _done(spool, name):
    with open(os.path.join(spool, "done", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture
def setup(tmp_path):
    data = str(tmp_path / "data")
    style = str(tmp_path / "style.png")
    _make_data(data)
    _style_png(style)
    return tmp_path, data, str(tmp_path / "spool"), style


def test_jobs_run_and_styler_cached(setup):
    tmp_path, data, spool, style = setup
    submit_job(spool, _job(data, str(tmp_path / "out1"), style,
                           frames=(0,)), name="a")
    submit_job(spool, _job(data, str(tmp_path / "out2"), style,
                           frames=(1,)), name="b")
    stats = _serve(spool, max_jobs=2)
    assert stats["jobs"] == 2
    assert stats["frames"] == 2
    # the second job reused the first job's styler
    assert stats["styler_cache_hits"] == 1
    for name, out in [("a", "out1"), ("b", "out2")]:
        res = _done(spool, name)
        assert res["status"] == "ok", res
        t = res["job"]["frames"][0]
        path = os.path.join(str(tmp_path / out), f"d_{t:04d}.npz")
        with np.load(path) as z:
            assert np.isfinite(z["d"]).all()
    # spool drained
    assert os.listdir(os.path.join(spool, "inbox")) == []
    assert os.listdir(os.path.join(spool, "work")) == []


def test_bad_job_isolated(setup):
    tmp_path, data, spool, style = setup
    submit_job(spool, _job("/nonexistent", str(tmp_path / "o"), style),
               name="bad")
    submit_job(spool, _job(data, str(tmp_path / "o"), style), name="good")
    # max_jobs counts processed jobs, errors included
    stats = _serve(spool, max_jobs=2)
    assert _done(spool, "bad")["status"] == "error"
    assert _done(spool, "good")["status"] == "ok"
    assert stats["jobs"] == 1
    assert stats["errors"] == 1


def test_failing_jobs_still_terminate(setup):
    tmp_path, _, spool, style = setup
    for name in ("x", "y"):
        submit_job(spool, _job("/nonexistent", str(tmp_path / "o"), style),
                   name=name)
    stats = _serve(spool, max_jobs=2)
    assert stats["jobs"] == 0
    assert stats["errors"] == 2


def test_transfer_fn_job(setup):
    # a coloured-smoke job: transfer_fn reaches the styler's colour render
    tmp_path, data, spool, style = setup
    job = _job(data, str(tmp_path / "outc"), style, frames=(0,))
    job["config"]["render.transfer_fn"] = "fire"
    job["config"]["render.tf_max_density"] = 1.5
    submit_job(spool, job, name="color")
    stats = _serve(spool, max_jobs=1)
    assert stats["jobs"] == 1
    assert _done(spool, "color")["status"] == "ok"
    with np.load(os.path.join(str(tmp_path / "outc"), "d_0000.npz")) as z:
        assert np.isfinite(z["d"]).all()


def _particle_job(data_dir, out_dir, style, weights):
    """A "parallel" particle job over 3 frames (keyframes 0 and 2) at
    small widths, one view (``render.view_pool`` 1), style weight 1000."""
    return {"mode": "particle", "data_dir": data_dir, "frames": [0, 1, 2],
            "out_dir": out_dir, "parallel": True, "grid_shape": [12, 12, 12],
            "style_target": style,
            "config": {"render.render_size": [32, 32], "render.n_views": 2,
                       "render.view_pool": 1, "render.transmit": 0.5,
                       "loss.style_layers": ["relu1_1"],
                       "loss.style_layer_weights": [1.0],
                       "loss.vgg_weights": weights, "loss.w_style": 1000.0,
                       "optim.octave_n": 2, "optim.iters": 2,
                       "particle.optimize_density": True,
                       "particle.keyframe_stride": 2}}


def test_parallel_jobs_match_jax_worker(setup):
    """"parallel" jobs through both packages' workers, with one VGG
    weights file and one view (``render.view_pool`` 1): a grid one runs
    the joint engine (ParallelSequenceStyler on the service's (1, 1)
    mesh) and a particle one the keyframe-parallel engine
    (ParallelKeyframeStyler on that mesh), the JAX worker's on its
    default mesh of the 8 virtual devices; the grid frames within 1e-3,
    the particles within the engines' parity tolerance (rtol 4e-3, atol
    4e-4; positions as offsets from the input frame). Then the particle
    job through the spool, another job after it: both succeed, the
    particle job writes the worker's frames again, and the worker stops
    cleanly."""
    from nfs_tpu_torch.io.npz import FrameStore

    tmp_path, data, spool, style = setup
    _make_data(data, T=2, shape=(12, 10, 12))
    weights = str(tmp_path / "vgg.npz")
    save_vgg_params(weights, jax.tree.map(np.asarray, init_vgg_params(0)))
    pdata = str(tmp_path / "pdata")
    rng = np.random.default_rng(7)
    x0 = rng.random((300, 3)) * 8 + 2
    for t in range(3):
        FrameStore(pdata).save_particles(
            t, x=(x0 + 0.2 * t).astype(np.float32),
            dens=np.ones(300, np.float32))
    outs, parts = {}, {}
    torch_worker = StylizeWorker("cpu")
    for name, worker in (("jax", JaxStylizeWorker()),
                         ("torch", torch_worker)):
        job = _job(data, str(tmp_path / name), style, frames=(0, 1))
        job["parallel"] = True
        job["config"].update({
            "loss.vgg_weights": weights, "loss.w_style": 1000.0,
            "render.view_pool": 1, "render.transmit": 0.5,
            "optim.window": 1, "optim.lr": 0.02})
        res = worker.run_job(job)
        assert res["status"] == "ok" and res["outputs"] == [
            "d_0000.npz", "d_0001.npz"]
        outs[name] = [np.load(os.path.join(str(tmp_path / name),
                                           f"d_{t:04d}.npz"))["d"]
                      for t in (0, 1)]
        pout = str(tmp_path / ("p" + name))
        res = worker.run_job(_particle_job(pdata, pout, style, weights))
        assert res["status"] == "ok" and res["outputs"] == [
            f"p_{t:04d}.npz" for t in range(3)]
        parts[name] = [FrameStore(pout).load_particles(t) for t in range(3)]
    for t, j in zip(outs["torch"], outs["jax"]):
        assert t.shape == j.shape == (12, 10, 12)
        assert np.abs(t - j).max() <= 1e-3
    for t, (p, j) in enumerate(zip(parts["torch"], parts["jax"])):
        # positions as offsets from the input frame
        x_in = (x0 + 0.2 * t).astype(np.float32)
        np.testing.assert_allclose(p["x"] - x_in, j["x"] - x_in,
                                   rtol=4e-3, atol=4e-4)
        np.testing.assert_allclose(p["dens"], j["dens"], rtol=4e-3,
                                   atol=4e-4)
    assert max(float(np.abs(p["x"] - x0 - 0.2 * t).max())
               for t, p in enumerate(parts["torch"])) > 1e-5

    submit_job(spool, _particle_job(pdata, str(tmp_path / "outp"), style,
                                    weights), name="par")
    submit_job(spool, _job(data, str(tmp_path / "ok"), style), name="z")
    stats = _serve(spool, max_jobs=2)
    assert _done(spool, "par")["status"] == "ok"
    assert _done(spool, "z")["status"] == "ok"
    assert stats["errors"] == 0 and stats["jobs"] == 2
    for t, want in enumerate(parts["torch"]):
        got = FrameStore(str(tmp_path / "outp")).load_particles(t)
        np.testing.assert_array_equal(got["x"], want["x"])
    # heartbeat file written and reports the final stats
    hb = [f for f in os.listdir(spool) if f.startswith("worker_")]
    assert hb, os.listdir(spool)
    with open(os.path.join(spool, hb[0])) as f:
        beat = json.load(f)
    assert beat["status"] == "stopped"
    assert beat["stats"]["jobs"] == 2


def test_json_list_config_values_hashable():
    # JSON has no tuples: list-valued overrides become tuples, so the
    # frozen config stays hashable for the styler cache
    job = _job("/d", "/o", None)
    job["config"] = {
        "render.render_size": [32, 32],
        "loss.style_layers": ["relu1_1", "relu2_1"],
        "loss.style_layer_weights": [1.0, 0.5],
        "optim.iters": 2,
    }
    cfg = _config_from_job(job)
    assert cfg.render.render_size == (32, 32)
    assert cfg.loss.style_layers == ("relu1_1", "relu2_1")
    hash(cfg)  # must not raise


def test_second_job_on_same_sequence_skips_reupload(setup, monkeypatch):
    # two queued jobs over the same frame files read and upload the
    # sequence once: the second finds it on the device
    import nfs_tpu_torch.io.npz as npz_mod

    tmp_path, data, spool, style = setup
    loads = {"n": 0}
    orig = npz_mod.FrameStore.load_density

    def counting(self, t):
        loads["n"] += 1
        return orig(self, t)

    monkeypatch.setattr(npz_mod.FrameStore, "load_density", counting)
    # different iterations -> different styler, same device input
    j1 = _job(data, str(tmp_path / "o1"), style, frames=(0, 1))
    j2 = _job(data, str(tmp_path / "o2"), style, frames=(0, 1))
    j2["config"]["optim.iters"] = 3
    submit_job(spool, j1, name="a")
    submit_job(spool, j2, name="b")
    stats = _serve(spool, max_jobs=2)
    assert stats["jobs"] == 2
    assert loads["n"] == 2  # frames read from disk once (2 frames)
    assert stats["frame_cache_hits"] == 1
    assert stats["frame_cache_misses"] == 1
    assert stats["upload_s_saved_est"] > 0
    for name in ("a", "b"):
        assert _done(spool, name)["status"] == "ok"


def test_frame_cache_invalidates_on_file_change(setup):
    # an overwritten frame file uploads again (the key is path + mtime +
    # size, not the path alone)
    tmp_path, data, _, style = setup
    worker = StylizeWorker("cpu")
    job = _job(data, str(tmp_path / "o"), style, frames=(0,))
    worker.run_job(job)
    p = os.path.join(data, "d_0000.npz")
    np.savez(p, d=np.full((16, 12), 0.5, np.float32))
    os.utime(p, (os.path.getmtime(p) + 5, os.path.getmtime(p) + 5))
    worker.run_job(job)
    assert worker.stats["frame_cache_hits"] == 0
    assert worker.stats["frame_cache_misses"] == 2


def test_frame_cache_lru_eviction(setup):
    # the byte budget holds: inserting past it evicts the least recently
    # used sequence
    tmp_path, data, _, style = setup
    worker = StylizeWorker("cpu")
    worker.cache_bytes = 16 * 12 * 4 + 8  # one 16x12 f32 frame + eps
    j0 = _job(data, str(tmp_path / "o0"), style, frames=(0,))
    j1 = _job(data, str(tmp_path / "o1"), style, frames=(1,))
    worker.run_job(j0)
    worker.run_job(j1)  # evicts frame 0's entry
    assert len(worker._frame_cache) == 1
    worker.run_job(j0)  # miss again
    assert worker.stats["frame_cache_misses"] == 3
    assert worker.stats["frame_cache_hits"] == 0
    assert worker._frame_cache_bytes <= worker.cache_bytes


def test_cached_frames_stay_on_worker_device(setup):
    """A cache hit hands the styler the very tensor of the first upload
    (a device tensor the styler takes without a copy)."""
    tmp_path, data, _, style = setup
    worker = StylizeWorker("cpu")
    job = _job(data, str(tmp_path / "o"), style, frames=(0, 1))
    from nfs_tpu_torch.io.npz import FrameStore

    store = FrameStore(data)
    d1, _ = worker._load_grid_cached(store, job, [0, 1])
    d2, _ = worker._load_grid_cached(store, job, [0, 1])
    assert d1 is d2 and d1.device == torch.device("cpu")
    assert d1.dtype == torch.float32 and tuple(d1.shape) == (2, 16, 12)


def test_stop_marker(tmp_path):
    spool = str(tmp_path / "spool")
    os.makedirs(spool, exist_ok=True)
    open(os.path.join(spool, "stop"), "w").close()
    stats = _serve(spool)
    assert stats["jobs"] == 0


def test_worker_refuses_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StylizeWorker("cuda")


@pytest.mark.parametrize("shape,frames", [((16, 12), (0,)),
                                          ((12, 10, 12), (0, 1))])
def test_jobs_match_jax_worker(tmp_path, shape, frames):
    """The same job through the JAX package's worker and the port's: one
    VGG weights file (``loss.vgg_weights``), one style PNG, one view
    (``render.view_pool`` 1). 2D: one frame (stylize_frame); 3D: two
    frames (stylize_sequence, warm-started)."""
    data = str(tmp_path / "data")
    style = str(tmp_path / "style.png")
    weights = str(tmp_path / "vgg.npz")
    _make_data(data, T=2, shape=shape)
    _style_png(style)
    save_vgg_params(weights, jax.tree.map(np.asarray, init_vgg_params(0)))
    outs = {}
    for name, worker in (("jax", JaxStylizeWorker()),
                         ("torch", StylizeWorker("cpu"))):
        job = _job(data, str(tmp_path / name), style, frames=frames)
        job["config"].update({
            "loss.vgg_weights": weights, "loss.w_style": 1000.0,
            "render.view_pool": 1, "render.transmit": 0.5,
            "render.min_render_size": 16, "optim.lr": 0.02})
        res = worker.run_job(job)
        assert res["status"] == "ok" and res["frames"] == len(frames)
        outs[name] = [np.load(os.path.join(str(tmp_path / name),
                                           f"d_{t:04d}.npz"))["d"]
                      for t in frames]
    # tests/test_torch_styler.py's sequence tolerance: f32 rounding
    # carried through the Adam steps; w_style 1000 keeps the random
    # VGG's gradients above Adam's eps (tests/test_torch_grid2d.py)
    for t, j in zip(outs["torch"], outs["jax"]):
        assert t.shape == j.shape == shape
        assert np.abs(t - j).max() <= 1e-3
