"""nfs_tpu_torch advection (K1-K3 plain twins, the window-tap sum and
MacCormack) against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both sides. The JAX
side is ``advect(impl='xla')`` (the XLA window sum) and ``advect_pallas``
in Pallas interpret mode, as tests/test_pallas.py runs it.

Tolerances: values atol 1e-5 and gradients atol 1e-4, as the JAX
package's own Pallas-vs-XLA tests hold them; both are float32 sums of the
same terms in another order (measured differences are ~1e-7).
"""

import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nfs_tpu.ops.advect import advect as jax_advect
from nfs_tpu.ops.advect import advect_maccormack as jax_maccormack
from nfs_tpu.ops.pallas_advect import advect_pallas
from nfs_tpu_torch.ops import advect_kernels as ak
from nfs_tpu_torch.ops.advect import advect, advect_maccormack

torch.set_num_threads(2)

VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _case(kind, shape=(10, 8, 12), max_disp=2.0, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.random(shape, dtype=np.float32)
    w = rng.standard_normal(shape, dtype=np.float32)  # loss weights
    if kind == "random":
        v = 0.8 * rng.standard_normal(shape + (3,), dtype=np.float32)
    elif kind == "clamped":  # many |v| > max_disp (F2)
        v = 3.0 * max_disp * rng.standard_normal(shape + (3,),
                                                 dtype=np.float32)
    elif kind == "zero":  # F1: every backtrace lands on a cell centre
        v = np.zeros(shape + (3,), np.float32)
    elif kind == "integer":  # F5: integer backtraces, three-tap gradient
        v = np.round(1.5 * rng.standard_normal(shape + (3,))).astype(
            np.float32)
    elif kind == "boundary":  # push every backtrace against the walls
        v = np.zeros(shape + (3,), np.float32)
        v[0, ..., 0] = 1.0
        v[-1, ..., 0] = -1.0
        v[:, 0, :, 1] = 2.0
        v[:, -1, :, 1] = -0.5
        v[..., 0, 2] = 0.7
        v[..., -1, 2] = -2.0
    else:
        raise ValueError(kind)
    return f, v, w


def _torch_value_and_grads(f, v, w, max_disp, impl="auto"):
    ft = torch.tensor(f, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    out = advect(ft, vt, max_disp=max_disp, impl=impl)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), ft.grad.numpy(), vt.grad.numpy()


def _jax_value_and_grads(fn, f, v, w):
    def loss(f, v):
        return jnp.sum(fn(f, v) * w)

    out = np.asarray(fn(jnp.asarray(f), jnp.asarray(v)))
    gf, gv = jax.grad(loss, argnums=(0, 1))(jnp.asarray(f), jnp.asarray(v))
    return out, np.asarray(gf), np.asarray(gv)


def _assert_match(got, want):
    out, gf, gv = got
    np.testing.assert_allclose(out, want[0], atol=VALUE_ATOL)
    np.testing.assert_allclose(gf, want[1], atol=GRAD_ATOL)
    np.testing.assert_allclose(gv, want[2], atol=GRAD_ATOL)


@pytest.mark.parametrize("max_disp", [1.0, 2.0])
@pytest.mark.parametrize("kind", ["random", "clamped", "zero", "integer",
                                  "boundary"])
def test_kernel_path_matches_xla_window(kind, max_disp):
    f, v, w = _case(kind, max_disp=max_disp)
    want = _jax_value_and_grads(
        lambda f, v: jax_advect(f, v, max_disp=max_disp, impl="xla"),
        f, v, w)
    got = _torch_value_and_grads(f, v, w, max_disp)
    _assert_match(got, want)
    if kind == "zero":  # F1: abs'(0) = +1 keeps the transport gradient
        assert np.abs(got[2]).max() > 0.0


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call,
                                             interpret=True))


@pytest.mark.parametrize("kind,max_disp", [("random", 2.0),
                                           ("integer", 1.0)])
def test_kernel_path_matches_pallas_interpret(interpret_mode, kind,
                                              max_disp):
    f, v, w = _case(kind, shape=(8, 8, 10), max_disp=max_disp, seed=5)
    want = _jax_value_and_grads(
        lambda f, v: advect_pallas(f, v, 1.0, max_disp, 4), f, v, w)
    _assert_match(_torch_value_and_grads(f, v, w, max_disp), want)


@pytest.mark.parametrize("kind", ["random", "zero", "integer"])
def test_plain_twins_match_each_other(kind):
    """K1-K3 twins against the window-tap sum (impl='xla') of the port:
    two independent formulations of the same function."""
    f, v, w = _case(kind, shape=(7, 9, 6), seed=3)
    want = _torch_value_and_grads(f, v, w, 2.0, impl="xla")
    _assert_match(_torch_value_and_grads(f, v, w, 2.0), want)


@pytest.mark.parametrize("mode", ["clamp", "zero"])
def test_window_taps_2d_and_zero_mode(mode):
    rng = np.random.default_rng(7)
    f = rng.random((9, 11), dtype=np.float32)
    v = 1.2 * rng.standard_normal((9, 11, 2), dtype=np.float32)
    w = rng.standard_normal((9, 11), dtype=np.float32)
    want = _jax_value_and_grads(
        lambda f, v: jax_advect(f, v, mode=mode, max_disp=2.0), f, v, w)
    ft = torch.tensor(f, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    out = advect(ft, vt, mode=mode, max_disp=2.0)
    (out * torch.from_numpy(w)).sum().backward()
    _assert_match((out.detach().numpy(), ft.grad.numpy(),
                   vt.grad.numpy()), want)


@pytest.mark.parametrize("channels", [None, 3])
def test_maccormack_matches(channels):
    rng = np.random.default_rng(11)
    shape = (8, 7, 9)
    f = rng.random(shape + ((channels,) if channels else ()),
                   dtype=np.float32)
    v = 1.1 * rng.standard_normal(shape + (3,), dtype=np.float32)
    want = np.asarray(jax_maccormack(jnp.asarray(f), jnp.asarray(v),
                                     max_disp=2.0))
    got = advect_maccormack(torch.from_numpy(f), torch.from_numpy(v),
                            max_disp=2.0).numpy()
    np.testing.assert_allclose(got, want, atol=VALUE_ATOL)


def test_backward_runs_only_needed_kernels(monkeypatch):
    """The autograd function skips K2 without a field gradient and K3
    without a velocity gradient."""
    calls = []
    for name in ("advect_bwd_field", "advect_bwd_vel"):
        orig = getattr(ak, name)
        monkeypatch.setattr(
            ak, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    f, v, _ = _case("random", shape=(5, 6, 7))
    ft = torch.tensor(f, requires_grad=True)
    ak.AdvectWindow.apply(ft, torch.from_numpy(v), 2.0).sum().backward()
    assert calls == ["advect_bwd_field"]
    calls.clear()
    vt = torch.tensor(v, requires_grad=True)
    ak.AdvectWindow.apply(torch.from_numpy(f), vt, 2.0).sum().backward()
    assert calls == ["advect_bwd_vel"]


def test_wrappers_check_inputs():
    f, v, _ = _case("random", shape=(4, 5, 6))
    ft, vt = torch.from_numpy(f), torch.from_numpy(v)
    with pytest.raises(TypeError):
        ak.advect_fwd(ft.double(), vt, 2.0)
    with pytest.raises(ValueError):
        ak.advect_fwd(ft, vt[..., :2].contiguous(), 2.0)
    strided = ft.transpose(0, 2).contiguous().transpose(0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ak.advect_fwd(strided, vt, 2.0)
    before = dict(ak.LAUNCHES)
    ak.advect_fwd(ft, vt, 2.0)  # CPU: the plain twin, no launch counted
    assert ak.LAUNCHES == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setattr(ak, "BUILD_DIR", tmp_path / "build")
    ak.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ak.load_library()
    ak.load_library.cache_clear()
