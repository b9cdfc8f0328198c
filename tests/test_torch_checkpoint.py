"""In-frame checkpoints of nfs_tpu_torch on the CPU: ``save_checkpoint``
and ``load_checkpoint`` round trips; a frame, a window sequence and a
CLI job interrupted after a chunk and resumed equal the uninterrupted
run bit for bit; a checkpoint written with another ``log_every``,
iteration budget or octave ladder is refused; a checkpointed frame runs
with cuDNN's deterministic convolutions and restores the settings.

A run is interrupted by raising from a hook that runs after the chunk's
checkpoint is written (the styler's ``callback``, or the checkpoint
writer itself for the CLI), never by a signal and a sleep. The view pool
holds 4 entries, so the resumed run must replay the view draws of the
octaves it skips.
"""

import os

import numpy as np
import pytest
import torch

from nfs_tpu_torch.cli import scene
from nfs_tpu_torch.cli.stylize import main
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.io.checkpoint import (
    load_checkpoint, read_meta, save_checkpoint)
from nfs_tpu_torch.io.npz import FrameStore
from nfs_tpu_torch.styler import grid as grid_mod
from nfs_tpu_torch.styler.grid import GridStyler
from nfs_tpu_torch.styler.octave import Adam, AdamState

torch.set_num_threads(2)

SHAPE = (12, 10, 12)
OVER = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 4,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1",),
    "loss.style_layer_weights": (1.0,),
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 4,
    "optim.lr": 0.02,
    "optim.log_every": 2,
    "optim.window": 1,
}


class Interrupt(Exception):
    pass


def _styler(**over):
    style = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)
    return GridStyler(replace(StyleConfig(), **dict(OVER, **over)),
                      style_image=style, device="cpu")


def _data(T=1, shape=SHAPE):
    rng = np.random.default_rng(0)
    d = rng.random((T,) + shape, dtype=np.float32)
    v = (0.7 * rng.standard_normal((T,) + shape + (len(shape),))).astype(
        np.float32)
    return d, v


def _stop_at(stop_octave, stop_done, calls=1):
    """A styler callback that raises at its `calls`-th call, which must be
    (stop_octave, stop_done)."""
    seen = []

    def cb(done, loss, octave):
        seen.append((octave, done))
        if len(seen) == calls:
            assert seen[-1] == (stop_octave, stop_done)
            raise Interrupt
    return cb


def _leaves(p):
    return ([p[k] for k in sorted(p)] if isinstance(p, dict) else [p])


def _assert_bits(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def test_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    tree = {"param": {"field": t(3, 4), "tf": t(8, 3)},
            "opt_state": AdamState(7, {"field": t(3, 4), "tf": t(8, 3)},
                                   {"field": t(3, 4), "tf": t(8, 3)})}
    meta = {"octave": 1, "iters_done": 4, "shapes": [[2, 2], [3, 4]]}
    path = str(tmp_path / "sub" / "ck.npz")
    save_checkpoint(path, tree, meta)
    assert sorted(os.listdir(tmp_path / "sub")) == ["ck.npz"]
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["__meta__", "leaf:param/field", "leaf:param/tf"]
            + [f"leaf:opt_state/{f}" + s for f in ("mu", "nu")
               for s in ("/field", "/tf")] + ["leaf:opt_state/count"])
    like = {"param": {"field": torch.zeros(3, 4), "tf": torch.zeros(8, 3)},
            "opt_state": Adam(0.1).init({"field": torch.zeros(3, 4),
                                         "tf": torch.zeros(8, 3)})}
    back, got_meta = load_checkpoint(path, like)
    assert got_meta == meta == read_meta(path)
    assert back["opt_state"].count == 7
    for a, b in ((back["param"], tree["param"]),
                 (back["opt_state"].mu, tree["opt_state"].mu),
                 (back["opt_state"].nu, tree["opt_state"].nu)):
        _assert_bits(a, b)
    # a tensor tree without meta
    save_checkpoint(path, t(5))
    got, m = load_checkpoint(path, torch.zeros(5, dtype=torch.float64))
    assert m is None and got.dtype == torch.float64


def test_load_refuses_a_missing_leaf_or_shape(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="leaf:b"):
        load_checkpoint(path, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, {"a": torch.zeros(4)})


@pytest.mark.parametrize("case", ["density_3d", "velocity_3d",
                                  "transfer_2d"])
def test_frame_resume_is_bit_equal(tmp_path, case):
    over, shape = {}, SHAPE
    if case == "velocity_3d":
        over = {"optim.parameterization": "velocity"}
    elif case == "transfer_2d":
        over = {"render.transfer_fn": "fire",
                "render.train_transfer": True}
        shape = (20, 16)
    d, v = _data(2, shape)
    vels = np.stack([v[0], v[1]])
    ts = _styler(**over)
    ref_d, ref_p, _ = ts.stylize_frame(d[0], vels=vels)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):
        ts.stylize_frame(d[0], vels=vels, checkpoint_path=path,
                         callback=_stop_at(1, 2, calls=3))
    assert read_meta(path)["octave"] == 1
    assert read_meta(path)["iters_done"] == 2
    got_d, got_p, info = ts.stylize_frame(d[0], vels=vels,
                                          checkpoint_path=path)
    assert not os.path.exists(path)
    # the resumed octave ran its last chunk only
    assert [len(l) for l in info["octave_losses"]] == [2]
    assert torch.equal(got_d, ref_d)
    _assert_bits(got_p, ref_p)


def test_checkpointed_frame_scopes_deterministic_convs(tmp_path):
    """A frame with an in-frame checkpoint runs with cuDNN's deterministic
    convolutions (a float32-feature frame on a GPU resumes with the bits
    only so), and the process's settings come back after it, whether it
    completes or is interrupted; a frame without one leaves them alone."""
    cudnn = torch.backends.cudnn
    d, v = _data(2)
    vels = np.stack([v[0], v[1]])
    seen = []

    def record(done, loss, octave):
        seen.append((cudnn.deterministic, cudnn.benchmark))

    before = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = False, True
    try:
        path = str(tmp_path / "ck.npz")
        with pytest.raises(Interrupt):
            _styler().stylize_frame(d[0], vels=vels, checkpoint_path=path,
                                    callback=_stop_at(0, 2))
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        _styler().stylize_frame(d[0], vels=vels, checkpoint_path=path,
                                callback=record)
        assert seen and set(seen) == {(True, False)}
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        seen.clear()
        _styler().stylize_frame(d[0], vels=vels, callback=record)
        assert set(seen) == {(False, True)}
    finally:
        cudnn.deterministic, cudnn.benchmark = before


def test_sequence_resume_is_bit_equal(tmp_path):
    """Interrupted in frame 1, octave 0, after its first chunk; the rerun
    continues the chain at frame 1 (frame 0's param, its velocity) and
    resumes the frame from its checkpoint."""
    d, v = _data(3)
    ts = _styler()
    ref = [(dd, p) for _, dd, p in ts.stylize_sequence(d, v)]
    ref_losses = dict(ts.frame_losses)
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):   # frame 0 makes 4 calls
        for _ in ts.stylize_sequence(d, v, checkpoint_path=path,
                                     callback=_stop_at(0, 2, calls=5)):
            pass
    assert read_meta(path)["octave"] == 0
    out = list(ts.stylize_sequence(
        d[1:], v[1:], checkpoint_path=path, init_param=ref[0][1],
        prev_velocity=v[0], frame_offset=1))
    assert not os.path.exists(path)
    assert [t for t, _, _ in out] == [0, 1]
    for (_, dd, p), (rd, rp) in zip(out, ref[1:]):
        assert torch.equal(dd, rd)
        assert torch.equal(p, rp)
    # the resumed frame ran its last 6 iterations: the first 2 are NaN
    got = ts.frame_losses[0]
    assert got.shape == ts.frame_losses[1].shape == (2, 4)
    assert torch.isnan(got.view(-1)[:2]).all()
    assert torch.equal(got.view(-1)[2:], ref_losses[1].view(-1)[2:])
    assert torch.equal(ts.frame_losses[1], ref_losses[2])


@pytest.mark.parametrize("key,over", [
    ("log_every", {"optim.log_every": 1}),
    ("iters", {"optim.iters": 6}),
    ("shapes", {"optim.octave_scale": 1.5}),
])
def test_mismatched_checkpoint_is_refused(tmp_path, key, over):
    d, v = _data(2)
    vels = np.stack([v[0], v[1]])
    path = str(tmp_path / "ck.npz")
    with pytest.raises(Interrupt):
        _styler().stylize_frame(d[0], vels=vels, checkpoint_path=path,
                                callback=_stop_at(0, 2))
    with pytest.raises(ValueError, match=f"written with {key}="):
        _styler(**over).stylize_frame(d[0], vels=vels, checkpoint_path=path)
    assert os.path.exists(path)


def test_cli_checkpoint_in_frame_resumes(tmp_path, monkeypatch, capsys):
    """A --checkpoint_in_frame 2D grid job whose checkpoint writer fails
    after its first write (the end of octave 0: log_every 10 exceeds the
    4 iterations) is rerun: the frame resumes at octave 1 and lands on
    the bits of a job run without checkpoints; the completed job leaves
    no checkpoint."""
    data = tmp_path / "data"
    scene.main(["--scene", "smoke2d", "--out", str(data), "--res", "24",
                "16", "--frames", "1", "--device", "cpu"])
    np.save(data / "style.npy",
            np.random.default_rng(0).random((32, 32, 3), dtype=np.float32))

    def run(tag, *extra):
        main(["--data_dir", str(data), "--log_dir", str(tmp_path / "log"),
              "--tag", tag, "--device", "cpu", "--render_size", "32", "32",
              "--octave_n", "2", "--octave_scale", "2.0", "--iter", "4",
              "--style_layer", "relu1_1", "--style_target",
              str(data / "style.npy"), *extra])
        return FrameStore(str(tmp_path / "log" / tag)).load_density(0)

    want = run("plain")
    writes = []
    real = grid_mod.save_checkpoint

    def failing(path, tree, meta=None):
        real(path, tree, meta)
        writes.append(meta)
        raise Interrupt

    monkeypatch.setattr(grid_mod, "save_checkpoint", failing)
    ckpt = tmp_path / "log" / "ck" / "inframe_ckpt.npz"
    with pytest.raises(Interrupt):
        run("ck", "--checkpoint_in_frame")
    assert len(writes) == 1 and ckpt.exists()
    assert (read_meta(str(ckpt))["octave"],
            read_meta(str(ckpt))["iters_done"]) == (0, 4)
    monkeypatch.setattr(grid_mod, "save_checkpoint", real)
    got = run("ck", "--checkpoint_in_frame")
    assert not ckpt.exists()
    np.testing.assert_array_equal(got, want)


def test_cli_fused_job_interrupted_mid_chunk_resumes(tmp_path, monkeypatch,
                                                     capsys):
    """A --fused 2 --checkpoint_in_frame 3D window job is interrupted
    inside its second chunk, after frame 3's first checkpoint write (the
    end of octave 0; log_every exceeds the 2 iterations, so every octave
    writes once). With checkpoints on, every frame's param is saved, so
    the rerun continues at frame 3 from param_0002 and frame 3's own
    checkpoint, never stepping back to frame 2 onto another frame's
    checkpoint; every frame equals a --fused 2 job without checkpoints."""
    data = tmp_path / "data"
    scene.main(["--scene", "smoke3d", "--out", str(data), "--res", "12",
                "10", "12", "--frames", "4", "--device", "cpu"])
    np.save(data / "style.npy",
            np.random.default_rng(0).random((32, 32, 3), dtype=np.float32))
    log = tmp_path / "log"

    def run(tag, *extra):
        main(["--data_dir", str(data), "--log_dir", str(log), "--tag", tag,
              "--device", "cpu", "--render_size", "32", "32", "--n_views",
              "2", "--octave_n", "2", "--octave_scale", "2.0", "--iter",
              "2", "--style_layer", "relu1_1", "--style_target",
              str(data / "style.npy"), "--num_frames", "4", "--window", "1",
              "--fused", "2", *extra])
        return [FrameStore(str(log / tag)).load_density(t) for t in range(4)]

    want = run("plain")
    writes = []
    real = grid_mod.save_checkpoint

    def failing(path, tree, meta=None):
        real(path, tree, meta)
        writes.append(meta)
        if len(writes) == 7:   # frames 0-2 wrote 2 each
            raise Interrupt

    monkeypatch.setattr(grid_mod, "save_checkpoint", failing)
    ck = log / "ck"
    with pytest.raises(Interrupt):
        run("ck", "--checkpoint_in_frame")
    assert (read_meta(str(ck / "inframe_ckpt.npz"))["octave"],
            read_meta(str(ck / "inframe_ckpt.npz"))["iters_done"]) == (0, 2)
    assert sorted(p for p in os.listdir(ck) if p.startswith("param")) == [
        "param_0000.npz", "param_0001.npz", "param_0002.npz"]
    monkeypatch.setattr(grid_mod, "save_checkpoint", real)
    capsys.readouterr()
    got = run("ck", "--checkpoint_in_frame")
    out = capsys.readouterr().out
    assert "[frame 3]" in out and "[frame 2]" not in out
    assert not (ck / "inframe_ckpt.npz").exists()
    for t in range(4):
        np.testing.assert_array_equal(got[t], want[t])
