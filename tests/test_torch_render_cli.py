"""nfs_tpu_torch's render CLI (``cli/render.py``) against the JAX
package's on the same ``.npz`` frames: 2D and 3D densities, particles
splatted onto a grid, grey and coloured by the 'fire' transfer function.
The PNGs must agree within one uint8 level (float32 renders of the same
terms in another order, rounded to 8 bits)."""


import numpy as np
import pytest
import torch
from PIL import Image

import nfs_tpu.utils.profiling as jax_profiling
from nfs_tpu.cli.render import main as jax_render
from nfs_tpu_torch.cli.render import main as torch_render
from nfs_tpu_torch.io.npz import FrameStore

torch.set_num_threads(2)


def _write_frames(data_dir, kind):
    rng = np.random.default_rng(5)
    store = FrameStore(data_dir)
    for t in range(2):
        if kind == "particle":
            store.save_particles(
                t, x=(rng.random((400, 3)) * 8 + 2).astype(np.float32),
                dens=(0.5 + rng.random(400)).astype(np.float32))
        else:
            shape = (16, 12) if kind == "2d" else (12, 10, 12)
            store.save_density(t, (2.0 * rng.random(shape)).astype(
                np.float32))


@pytest.mark.parametrize("kind,extra", [
    ("2d", []),
    ("3d", []),
    ("3d", ["--transfer_fn", "fire", "--theta", "30", "--phi", "10"]),
    ("particle", ["--mode", "particle", "--grid_shape", "12", "10", "12"]),
])
def test_render_cli_matches_jax(tmp_path, monkeypatch, kind, extra):
    # the JAX CLI's persistent compile cache would write outside tmp_path
    monkeypatch.setattr(jax_profiling, "enable_compile_cache",
                        lambda *a, **k: None)
    data = str(tmp_path / "data")
    _write_frames(data, kind)
    common = ["--data_dir", data, "--num_frames", "2", "--render_size",
              "32", "32", "--transmit", "0.05"] + extra
    jax_render(common + ["--out", str(tmp_path / "jax")])
    torch_render(common + ["--out", str(tmp_path / "torch"),
                           "--device", "cpu"])
    for t in range(2):
        name = f"frame_{t:04d}.png"
        with Image.open(tmp_path / "jax" / name) as f:
            want = np.asarray(f, dtype=np.int16)
        with Image.open(tmp_path / "torch" / name) as f:
            got = np.asarray(f, dtype=np.int16)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1
        assert got.max() > got.min()    # not a constant image


def test_render_cli_refuses_missing_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_render(["--data_dir", str(tmp_path)])
