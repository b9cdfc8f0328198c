"""In-frame checkpoint files shared by the two packages (ROADMAP queue 3,
F16): each package's ``load_checkpoint`` reads what the other's
``save_checkpoint`` wrote, every leaf bitwise, for a tensor param and for
the ``{'field', 'tf'}`` param of ``render.train_transfer``; and a
``--checkpoint_in_frame`` job that the JAX CLI started and stopped after
its first chunk is finished by the port's CLI, which leaves no file
behind. The numerical parity of a resumed frame is held at the library
level (``tests/test_torch_styler.py``): the CLIs draw their views from
different generators.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nfs_tpu.cli import stylize as jax_stylize
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.io import checkpoint as jax_checkpoint
from nfs_tpu.utils import profiling as jax_profiling
from nfs_tpu_torch.cli import scene
from nfs_tpu_torch.cli import stylize as torch_stylize
from nfs_tpu_torch.core.config import replace
from nfs_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from nfs_tpu_torch.io.image import save_image
from nfs_tpu_torch.io.npz import FrameStore
from nfs_tpu_torch.styler.grid import GridStyler
from nfs_tpu_torch.styler.octave import Adam, AdamState

torch.set_num_threads(2)

META = {"octave": 1, "iters_done": 2, "log_every": 2, "iters": 4,
        "shapes": [[3, 4, 5], [6, 8, 10]]}


def _arrays(kind, seed):
    """Numpy leaves of a param tree: a velocity field, or the trained
    transfer function's {field, tf}."""
    rng = np.random.default_rng(seed)
    field = rng.standard_normal((6, 8, 10, 3)).astype(np.float32)
    if kind == "tensor":
        return field
    return {"field": field,
            "tf": rng.standard_normal((8, 3)).astype(np.float32)}


def _map(fn, tree):
    return ({k: fn(v) for k, v in tree.items()} if isinstance(tree, dict)
            else fn(tree))


def _leaves(tree):
    return ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
            else [tree])


def _jax_tree(p, mu, nu, count):
    j = lambda t: _map(jnp.asarray, t)
    state = (optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32),
                                    mu=j(mu), nu=j(nu)), optax.EmptyState())
    return {"param": j(p), "opt_state": state}


def _port_tree(p, mu, nu, count):
    t = lambda x: _map(torch.from_numpy, x)
    return {"param": t(p), "opt_state": AdamState(count, t(mu), t(nu))}


@pytest.mark.parametrize("kind", ["tensor", "transfer"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_file(tmp_path, writer, kind):
    """The file one package writes loads in the other into a freshly
    initialized template, every leaf bitwise, Adam's step count too, and
    with the metadata both read."""
    p, mu, nu = (_arrays(kind, s) for s in (0, 1, 2))
    path = str(tmp_path / "inframe_ckpt.npz")
    zeros = _map(np.zeros_like, p)
    if writer == "port":
        save_checkpoint(path, _port_tree(p, mu, nu, 7), META)
        like = _map(jnp.asarray, zeros)
        back, meta = jax_checkpoint.load_checkpoint(
            path, {"param": like, "opt_state": optax.adam(0.1).init(like)})
        state = back["opt_state"][0]
        count = int(state.count)
        assert state.count.dtype == jnp.int32
    else:
        jax_checkpoint.save_checkpoint(path, _jax_tree(p, mu, nu, 7), META)
        like = _map(torch.from_numpy, zeros)
        back, meta = load_checkpoint(
            path, {"param": like, "opt_state": Adam(0.1).init(like)})
        state = back["opt_state"]
        count = state.count
    assert meta == META and count == 7
    for got, want in ((back["param"], p), (state.mu, mu), (state.nu, nu)):
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(np.asarray(a), b)


class Interrupt(Exception):
    pass


def test_port_cli_finishes_a_jax_cli_job(tmp_path, monkeypatch, capsys):
    """A 2D ``--checkpoint_in_frame`` job (log_every 2, two octaves of 4
    iterations) through the JAX CLI, whose checkpoint writer raises after
    its first write (octave 0, 2 iterations done); the port's CLI, given
    the same flags, resumes that file (not the frame from scratch),
    writes a finite frame of the job's shape, and removes the file."""
    monkeypatch.setattr(jax_profiling, "enable_compile_cache",
                        lambda *a, **k: None)
    for mod, rep in ((jax_stylize, jax_replace), (torch_stylize, replace)):
        orig = mod.config_from_args
        monkeypatch.setattr(
            mod, "config_from_args",
            lambda a, orig=orig, rep=rep: rep(orig(a),
                                              **{"optim.log_every": 2}))
    data = tmp_path / "data"
    scene.main(["--scene", "smoke2d", "--out", str(data), "--res", "24",
                "16", "--frames", "1", "--device", "cpu"])
    save_image(str(data / "style.png"), np.random.default_rng(0).random(
        (32, 32, 3), dtype=np.float32))
    flags = ["--data_dir", str(data), "--log_dir", str(tmp_path / "log"),
             "--tag", "job", "--render_size", "32", "32", "--octave_n", "2",
             "--octave_scale", "2.0", "--iter", "4", "--style_layer",
             "relu1_1", "--style_target", str(data / "style.png"),
             "--checkpoint_in_frame"]
    real, writes = jax_checkpoint.save_checkpoint, []

    def failing(path, tree, meta=None):
        real(path, tree, meta)
        writes.append(meta)
        raise Interrupt

    monkeypatch.setattr(jax_checkpoint, "save_checkpoint", failing)
    with pytest.raises(Interrupt):
        jax_stylize.main(flags)
    ckpt = tmp_path / "log" / "job" / "inframe_ckpt.npz"
    assert len(writes) == 1 and ckpt.exists()
    assert (writes[0]["octave"], writes[0]["iters_done"]) == (0, 2)
    resumed = []
    resume = GridStyler._resume

    def spy(self, path, *args):
        out = resume(self, path, *args)
        resumed.append(out[:2])
        return out

    monkeypatch.setattr(GridStyler, "_resume", spy)
    torch_stylize.main(flags + ["--device", "cpu"])
    assert resumed == [(0, 2)]
    assert not ckpt.exists()
    out = FrameStore(str(tmp_path / "log" / "job")).load_density(0)
    assert out.shape == (24, 16) and np.isfinite(out).all()
