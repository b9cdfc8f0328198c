"""nfs_tpu_torch advection (K1-K3b plain twins, the window-tap sum and
MacCormack) against the JAX package on the CPU, and the shared-memory
tile plan of the K2 / K3b kernels.

Inputs are made with numpy from a seed and fed to both sides. The JAX
side is ``advect(impl='xla')`` (the XLA window sum) and ``advect_pallas``
in Pallas interpret mode, as tests/test_pallas.py runs it.

Tolerances: values atol 1e-5 and gradients atol 1e-4, as the JAX
package's own Pallas-vs-XLA tests hold them; both are float32 sums of the
same terms in another order (measured differences are ~1e-7).
"""

import functools
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nfs_tpu.ops.advect import advect as jax_advect
from nfs_tpu.ops.advect import advect_maccormack as jax_maccormack
from nfs_tpu.ops import pallas_advect as pa
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


@pytest.mark.parametrize("max_disp", [1.0, 2.0, 3.0, 1.5])
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


_WRAPPERS = {
    "fwd": lambda f, v, g: ak.advect_fwd(f, v, 2.0),
    "bwd_field": lambda f, v, g: ak.advect_bwd_field(v, g, 2.0),
    "bwd_vel": lambda f, v, g: ak.advect_bwd_vel(f, v, g, 2.0),
    "bwd_fused": lambda f, v, g: ak.advect_bwd_fused(f, v, g, 2.0),
}


@pytest.mark.parametrize("key", sorted(_WRAPPERS))
@pytest.mark.parametrize("bad,error,match", [
    ("nothing", None, None),
    ("float64", TypeError, "float32"),
    ("vel short", ValueError, "shape"),
    ("vel not contiguous", ValueError, "contiguous"),
    ("rank 2", ValueError, None),
    ("vel on another device", ValueError, "expected"),
    ("all on the meta device", RuntimeError, "cpu or cuda"),
])
def test_wrappers_check_inputs(key, bad, error, match):
    """The one-pass check of every advection wrapper raises on a wrong
    type, shape, layout, rank or device of any tensor, and on a device
    that is neither cpu nor cuda; on good CPU tensors the wrapper runs
    its plain twin and counts no launch."""
    f, v, w = (torch.from_numpy(a) for a in _case("random", shape=(4, 5, 6)))
    if bad == "float64":
        f, w = f.double(), w.double()
    elif bad == "vel short":
        v = v[..., :2].contiguous()
    elif bad == "vel not contiguous":
        v = v.transpose(0, 2).contiguous().transpose(0, 2)
    elif bad == "rank 2":
        f, w = f[0], w[0]
    elif bad == "vel on another device":
        v = v.to("meta")
    elif bad == "all on the meta device":
        f, v, w = (t.to("meta") for t in (f, v, w))
    before = dict(ak.LAUNCHES)
    if error is None:
        _WRAPPERS[key](f, v, w)
    else:
        with pytest.raises(error, match=match):
            _WRAPPERS[key](f, v, w)
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


def test_operator_build_raises_without_host_compiler(monkeypatch,
                                                    tmp_path):
    """The operators (csrc/ops.cpp) are built with the host compiler next
    to the kernels; without one the build refuses before any compile
    starts, and nothing is written."""
    from nfs_tpu_torch.ops import _cuda_build

    monkeypatch.setattr(_cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    ak.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="host C\\+\\+ compiler"):
        ak.load_library()
    ak.load_library.cache_clear()
    assert not (tmp_path / "build").exists()


def test_operators_match_the_wrappers():
    """Every operator csrc/ops.cpp defines is registered for CUDA and
    called by one wrapper, but for K2's untiled pull (on no path: the
    oracle chip_smoke.py holds the binned route against); each wrapper's
    operator exists, and each operator's C entry point is one advect.cu
    or binsplat.cu defines."""
    import re

    from nfs_tpu_torch.ops import _cuda_build
    from nfs_tpu_torch.ops import binsplat_kernels as bk

    ops = (_cuda_build.CSRC / "ops.cpp").read_text()
    defined = set(re.findall(r'm\.def\(\s*"(\w+)\(', ops))
    registered = set(re.findall(r'm\.impl\("(\w+)"', ops))
    wrappers = "".join(Path(m.__file__).read_text() for m in (ak, bk))
    called = set(re.findall(r"load_library\(\)\.(\w+)\.default", wrappers))
    assert defined == registered == called | {"advect_bwd_field_untiled"}
    assert called == {
        "advect_fwd", "advect_bwd_field", "advect_bin_sources",
        "advect_bwd_field_binned", "advect_bwd_vel", "advect_bwd_fused",
        "binsplat_fwd", "binsplat_bwd", "binsplat_color_fwd",
        "binsplat_color_bwd"}
    sources = "".join((_cuda_build.CSRC / src).read_text()
                      for src, _ in _cuda_build.KERNEL_SOURCES)
    entry = set(re.findall(r"^int (nfs_\w+)\(", sources, re.M))
    assert entry == {f"nfs_{name}" for name in defined}
    assert entry == set(re.findall(r"^int (nfs_\w+)\(", ops, re.M))


def _grads_of_square_loss(f, v, max_disp):
    """Gradients of sum(advect(f, v)^2) in f and v through the port."""
    ft = torch.tensor(f, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    (ak.AdvectWindow.apply(ft, vt, max_disp) ** 2).sum().backward()
    return ft.grad.numpy(), vt.grad.numpy()


@pytest.mark.parametrize("kind", ["random", "zero"])
def test_fused_backward_matches_jax_fused(interpret_mode, monkeypatch,
                                          kind):
    """FUSED_BWD on both sides: K3b's plain version against the JAX
    package's _bwd_fused_kernel in Pallas interpret mode, for the
    gradients of sum(advect(f, v)^2)."""
    monkeypatch.setattr(pa, "FUSED_BWD", True)
    monkeypatch.setattr(ak, "FUSED_BWD", True)
    f, v, _ = _case(kind, shape=(12, 10, 14), seed=8)
    jg = jax.grad(lambda f, v: jnp.sum(advect_pallas(f, v, 1.0, 2.0, 4)
                                       ** 2), argnums=(0, 1))(
        jnp.asarray(f), jnp.asarray(v))
    got = _grads_of_square_loss(f, v, 2.0)
    # f32 sums of the same terms in another order (measured 2.1e-7 of
    # max|g| on the random case, 0 on the zero case)
    for g_t, g_j in zip(got, jg):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t, g_j,
                                   atol=1e-5 * float(np.abs(g_j).max()))
    if kind == "zero":  # F1: abs'(0) = +1 keeps the transport gradient
        assert np.abs(got[1]).max() > 0.0


@pytest.mark.parametrize("kind", ["random", "integer", "boundary"])
def test_fused_backward_equals_split(monkeypatch, kind):
    """K3b's plain version computes K2's and K3's plain versions, so the
    fused backward's gradients equal the split backward's exactly."""
    f, v, _ = _case(kind, shape=(7, 9, 6), seed=4)
    split = _grads_of_square_loss(f, v, 2.0)
    monkeypatch.setattr(ak, "FUSED_BWD", True)
    fused = _grads_of_square_loss(f, v, 2.0)
    for a, b in zip(fused, split):
        np.testing.assert_array_equal(a, b)


def test_fused_backward_runs_one_kernel_for_what_is_asked(monkeypatch):
    """With FUSED_BWD the backward calls K3b once where both inputs need a
    gradient, and K2 alone or K3 alone where only one does, never K3b
    then; it returns only the gradients asked for."""
    calls = []
    for name in ("advect_bwd_field", "advect_bwd_vel", "advect_bwd_fused"):
        orig = getattr(ak, name)
        monkeypatch.setattr(
            ak, name, lambda *a, _o=orig, _n=name: calls.append(_n) or _o(*a))
    monkeypatch.setattr(ak, "FUSED_BWD", True)
    f, v, _ = _case("random", shape=(5, 6, 7))
    for need_f, need_v, called in (
            (True, False, ["advect_bwd_field"]),
            (False, True, ["advect_bwd_vel"]),
            (True, True, ["advect_bwd_fused"])):
        ft = torch.tensor(f, requires_grad=need_f)
        vt = torch.tensor(v, requires_grad=need_v)
        ak.AdvectWindow.apply(ft, vt, 2.0).sum().backward()
        assert calls == called
        assert (ft.grad is not None, vt.grad is not None) == (need_f, need_v)
        calls.clear()


def test_fused_wrapper_checks_inputs():
    f, v, w = _case("random", shape=(4, 5, 6))
    ft, vt, gt = (torch.from_numpy(a) for a in (f, v, w))
    with pytest.raises(ValueError):
        ak.advect_bwd_fused(ft, vt, gt[:3].contiguous(), 2.0)
    with pytest.raises(TypeError):
        ak.advect_bwd_fused(ft, vt.double(), gt, 2.0)
    before = dict(ak.LAUNCHES)
    gf, gs = ak.advect_bwd_fused(ft, vt, gt, 2.0)  # CPU: plain, no launch
    assert ak.LAUNCHES == before
    assert gf.shape == (4, 5, 6) and gs.shape == (4, 5, 6, 3)


def _staged_bytes(R, tile, fused):
    """advect.cu's shared memory for K2 / K3b, written out independently:
    s_z, s_y, s_x and g (4 floats) per source of the tile with its
    R-halo, and for K3b f over the tile with an (R+1)-halo."""
    tz, ty, tx = tile
    sources = (tz + 2 * R) * (ty + 2 * R) * (tx + 2 * R)
    f = (tz + 2 * R + 2) * (ty + 2 * R + 2) * (tx + 2 * R + 2)
    return 16 * sources + (4 * f if fused else 0)


@pytest.mark.parametrize("R", range(9))
def test_pull_plan_fits_shared_memory(R):
    """The tile K2 and K3b stage at radius R: the staged bytes follow the
    formula, fit in the H100's 232 448 B a block may use, and the tile
    covers at least one cell with whole threads of CELLS_X cells, at
    most 1024 of them; the wrapper's formula agrees."""
    for fused in (False, True):
        if R > 7 + (not fused):
            continue  # past the plan's limit (next test)
        tz, ty, tx, nbytes = ak._pull_plan(R, fused)
        assert min(tz, ty, tx) >= 1 and tx % ak.CELLS_X == 0
        assert tz * ty * tx // ak.CELLS_X <= 1024
        assert nbytes == _staged_bytes(R, (tz, ty, tx), fused)
        assert nbytes == ak._staged_bytes(R, (tz, ty, tx), fused)
        assert nbytes <= 232_448
        if _staged_bytes(R, ak.PULL_TILE, fused) <= 232_448:
            assert (tz, ty, tx) == ak.PULL_TILE
        else:  # shrunk in z, then y, never in x
            assert tx == ak.PULL_TILE[2] and tz < ak.PULL_TILE[0]


def test_pull_plan_raises_past_its_limit():
    """K2 takes a tile up to R = 8 and K3b up to 7; past that even a
    1 x 1 x 24 tile does not fit, and the plan returns None instead of a
    tile (K2's wrapper takes its binned route from BINNED_FROM_R, before
    that; K3b's runs K2 and K3); a negative radius still raises."""
    assert ak._pull_plan(8)[:3] == (1, 4, 24)
    assert ak._pull_plan(7, fused=True)[:3] == (1, 4, 24)
    for R, fused in ((9, False), (8, True), (12, False), (40, True)):
        assert ak._pull_plan(R, fused) is None
    for fused in (False, True):
        with pytest.raises(ValueError):
            ak._pull_plan(-1, fused)


def test_matches_jax_past_the_tile_plan():
    """At max_disp 9.5 (R = 10, past both tile plans, where the CUDA
    wrappers take K2's binned route and K2 + K3) the port's value and both
    gradients through ``advect`` match the JAX package's XLA window, with
    displacements reaching across most of the grid and the largest
    clamped."""
    rng = np.random.default_rng(21)
    shape = (12, 14, 20)
    f = rng.random(shape, dtype=np.float32)
    v = 4.0 * rng.standard_normal(shape + (3,), dtype=np.float32)
    w = rng.standard_normal(shape, dtype=np.float32)
    assert (np.abs(v) > 9.5).any() and (np.abs(v) > 3.0).mean() > 0.4

    def loss(f, v):
        out = jax_advect(f, v, max_disp=9.5, impl="xla")
        return jnp.sum(out * w), out

    # value and both gradients from one compile of the 23-tap window
    (_, out), (gf, gv) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(f), jnp.asarray(v))
    want = (np.asarray(out), np.asarray(gf), np.asarray(gv))
    _assert_match(_torch_value_and_grads(f, v, w, 9.5), want)
