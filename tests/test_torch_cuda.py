"""CUDA kernels K1-K5 and K3b of nfs_tpu_torch against their plain
versions, on the GPU. Every test here needs a CUDA device and skips
without one.

This file imports no JAX, so it also runs where only the port and torch
are installed; tests/conftest.py imports JAX, so there run it as
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

Tolerances: values atol 1e-5, gradients atol 1e-4 (float32 sums of the
same terms in another order; K2's plain twin scatters with atomics).
"""

import numpy as np
import pytest
import torch

from nfs_tpu_torch.ops import advect_kernels as ak
from nfs_tpu_torch.ops import binsplat as B
from nfs_tpu_torch.ops import binsplat_kernels as bk
from nfs_tpu_torch.ops.advect import advect

torch.set_num_threads(2)

VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(kind, max_disp, shape=(24, 16, 40), seed=0):
    rng = np.random.default_rng(seed)
    f = rng.random(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    v = (max_disp / 1.2816) * rng.standard_normal(shape + (3,),
                                                  dtype=np.float32)
    if kind == "integer":
        v = np.round(v)
    elif kind == "zero":
        v = np.zeros_like(v)
    return f, g, v


@pytest.mark.cuda
@pytest.mark.parametrize("kind,max_disp", [("random", 2.0), ("random", 1.0),
                                           ("integer", 2.0), ("zero", 1.0)])
def test_kernels_match_plain(cuda_device, kind, max_disp):
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(kind, max_disp))
    before = dict(ak.LAUNCHES)
    torch.testing.assert_close(ak.advect_fwd(f, v, max_disp),
                               ak.advect_fwd_plain(f, v, max_disp),
                               atol=VALUE_ATOL, rtol=0)
    torch.testing.assert_close(ak.advect_bwd_field(v, g, max_disp),
                               ak.advect_bwd_field_plain(v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(ak.advect_bwd_vel(f, v, g, max_disp),
                               ak.advect_bwd_vel_plain(f, v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)
    assert all(ak.LAUNCHES[k] == before[k] + 1
               for k in ("fwd", "bwd_field", "bwd_vel"))
    assert ak.LAUNCHES["bwd_fused"] == before["bwd_fused"]


@pytest.mark.cuda
def test_advect_on_gpu_matches_cpu(cuda_device):
    """The whole autograd path (kernels + clip-gradient chain) on the GPU
    against the same call on the CPU (plain twins)."""
    f, g, v = _inputs("random", 2.0, seed=4)
    outs = {}
    for dev in ("cpu", cuda_device):
        ft = torch.tensor(f, device=dev, requires_grad=True)
        vt = torch.tensor(v, device=dev, requires_grad=True)
        out = advect(ft, vt, max_disp=2.0)
        (out * torch.tensor(g, device=dev)).sum().backward()
        outs[str(dev)] = [t.detach().cpu() for t in (out, ft.grad, vt.grad)]
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(gpu[0], cpu[0], atol=VALUE_ATOL, rtol=0)
    torch.testing.assert_close(gpu[1], cpu[1], atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(gpu[2], cpu[2], atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda_device):
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", 2.0))
    with pytest.raises(ValueError):  # field on the GPU, vel on the CPU
        ak.advect_fwd(f, v.cpu(), 2.0)
    with pytest.raises(ValueError):  # not contiguous
        ak.advect_bwd_field(v, g.transpose(0, 2), 2.0)
    with pytest.raises(TypeError):
        ak.advect_bwd_vel(f.half(), v, g, 2.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,max_disp", [("random", 2.0), ("random", 1.0),
                                           ("integer", 2.0), ("zero", 1.0)])
def test_fused_kernel_matches_plain_and_split(cuda_device, kind, max_disp):
    """K3b against its plain version and against K2 + K3 launched
    separately (the same device functions, so the same sums)."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(kind, max_disp, seed=2))
    before = dict(ak.LAUNCHES)
    gf, gs = ak.advect_bwd_fused(f, v, g, max_disp)
    assert ak.LAUNCHES["bwd_fused"] == before["bwd_fused"] + 1
    for got, want in zip((gf, gs),
                         ak.advect_bwd_fused_plain(f, v, g, max_disp)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(gf, ak.advect_bwd_field(v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(gs, ak.advect_bwd_vel(f, v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "integer", "zero"])
@pytest.mark.parametrize("max_disp", [0.0, 1.0, 1.5, 3.0, 4.0])
@pytest.mark.parametrize("shape", [(13, 7, 37), (1, 1, 5), (3, 64, 2)])
def test_pull_kernels_on_ragged_tiles(cuda_device, shape, max_disp, kind):
    """K2 and K3b (shared-memory tiles, R = 0-4) on shapes that are not
    multiples of the tile or are smaller than its halo: against their
    plain versions, K3b against K2 + K3 exactly, and two launches
    bitwise equal (no atomics)."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(kind, max(max_disp, 0.5), shape, seed=9))
    gf = ak.advect_bwd_field(v, g, max_disp)
    fused = ak.advect_bwd_fused(f, v, g, max_disp)
    torch.testing.assert_close(gf, ak.advect_bwd_field_plain(v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)
    for got, want in zip(fused, ak.advect_bwd_fused_plain(f, v, g,
                                                          max_disp)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    assert torch.equal(fused[0], gf)
    assert torch.equal(fused[1], ak.advect_bwd_vel(f, v, g, max_disp))
    assert torch.equal(ak.advect_bwd_field(v, g, max_disp), gf)
    again = ak.advect_bwd_fused(f, v, g, max_disp)
    assert torch.equal(again[0], fused[0]) and torch.equal(again[1],
                                                           fused[1])


@pytest.mark.cuda
@pytest.mark.parametrize("R", range(10))
def test_pull_kernels_every_radius_of_the_plan(cuda_device, R):
    """Every radius the tile plan takes runs on the card (K2 to R = 8,
    K3b to R = 7, the largest on a shrunk tile); one more raises
    ValueError and launches nothing."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", max(R, 0.5), (13, 7, 37), seed=R))
    md = float(R)
    before = dict(ak.LAUNCHES)
    if R <= 8:
        torch.testing.assert_close(ak.advect_bwd_field(v, g, md),
                                   ak.advect_bwd_field_plain(v, g, md),
                                   atol=GRAD_ATOL, rtol=0)
        assert ak.LAUNCHES["bwd_field"] == before["bwd_field"] + 1
    else:
        with pytest.raises(ValueError):
            ak.advect_bwd_field(v, g, md)
        assert ak.LAUNCHES == before
    before = dict(ak.LAUNCHES)
    if R <= 7:
        for got, want in zip(ak.advect_bwd_fused(f, v, g, md),
                             ak.advect_bwd_fused_plain(f, v, g, md)):
            torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
        assert ak.LAUNCHES["bwd_fused"] == before["bwd_fused"] + 1
    else:
        with pytest.raises(ValueError):
            ak.advect_bwd_fused(f, v, g, md)
        assert ak.LAUNCHES == before


def _pull_on_tile(f, g, v, max_disp, tile, fused):
    """K2 (``fused=False``) or K3b launched through the C interface on a
    given (TZ, TY, TX) tile instead of the plan's."""
    lib = ak.load_library()
    D, H, W = g.shape
    R = ak._radius(max_disp)
    nbytes = ak._staged_bytes(R, tile, fused)
    stream = ak._stream(g.device)
    gf = torch.empty_like(g)
    if not fused:
        ak._raise_on(lib.nfs_advect_bwd_field(
            v.data_ptr(), g.data_ptr(), gf.data_ptr(), D, H, W, max_disp, R,
            *tile, nbytes, stream), "advect_bwd_field")
        return (gf,)
    gs = torch.empty_like(v)
    ak._raise_on(lib.nfs_advect_bwd_fused(
        f.data_ptr(), v.data_ptr(), g.data_ptr(), gf.data_ptr(),
        gs.data_ptr(), D, H, W, max_disp, R, *tile, nbytes, stream),
        "advect_bwd_fused")
    return gf, gs


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(2, 8, 48), (1, 1, 3), (8, 8, 12)])
@pytest.mark.parametrize("max_disp", [2.0, 3.0])
def test_pull_kernels_same_bits_on_any_tile(cuda_device, tile, max_disp):
    """K2 and K3b sum every cell's sources in the same order whatever the
    tile: another tile (one over the 48 KB that needs no opt-in among
    them) gives the plan's bits."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", max_disp, (13, 7, 37), seed=5))
    assert torch.equal(_pull_on_tile(f, g, v, max_disp, tile, False)[0],
                       ak.advect_bwd_field(v, g, max_disp))
    for got, want in zip(_pull_on_tile(f, g, v, max_disp, tile, True),
                         ak.advect_bwd_fused(f, v, g, max_disp)):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_fused_backward_on_gpu_matches_split(cuda_device, monkeypatch):
    """AdvectWindow's backward with FUSED_BWD (one K3b launch) against the
    split backward (K2 and K3) on the GPU."""
    f, _, v = _inputs("random", 2.0, seed=6)
    grads = {}
    for fused in (False, True):
        monkeypatch.setattr(ak, "FUSED_BWD", fused)
        ft = torch.tensor(f, device=cuda_device, requires_grad=True)
        vt = torch.tensor(v, device=cuda_device, requires_grad=True)
        before = dict(ak.LAUNCHES)
        (advect(ft, vt, max_disp=2.0) ** 2).sum().backward()
        launched = {k: ak.LAUNCHES[k] - before[k] for k in before}
        assert launched["bwd_fused"] == (1 if fused else 0)
        assert launched["bwd_field"] == launched["bwd_vel"] == (
            0 if fused else 1)
        grads[fused] = (ft.grad, vt.grad)
    for got, want in zip(grads[True], grads[False]):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)


def _bins(case, shape=(20, 14, 24), n=6000, seed=0):
    """Binned particles as the styler's window sees them: (p_b, a_b,
    Binning, K). 'drift' moves them +-0.5 cell after binning, 'parked'
    crowds a cell past K = 2, 'integer' puts them on integer positions."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 3)) * (np.array(shape) - 1)).astype(np.float32)
    K = 4
    if case == "parked":
        x[: n // 10] = 5.0 + 0.05 * rng.random((n // 10, 3))
        K = 2
    elif case == "integer":
        x = np.round(x)
    bn = B.bin_particles(torch.from_numpy(x), shape, K)
    if case == "drift":
        x = x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    p_b = B.to_binned(bn, torch.from_numpy(x))
    a_b = B.to_binned(bn, torch.from_numpy(
        rng.random(n, dtype=np.float32)))
    return p_b, a_b, bn, K, shape


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["binned", "drift", "parked", "integer"])
def test_binsplat_kernels_match_plain(cuda_device, case):
    p_b, a_b, bn, K, shape = _bins(case)
    pshape = B.padded_shape(shape)
    n_slots = bn.valid.shape[0]
    a4 = torch.where(bn.valid, a_b[:n_slots], 0.0).view((K,) + pshape)
    p4 = [p_b[d, :n_slots].view((K,) + pshape).contiguous()
          for d in range(3)]
    a4, p4 = a4.to(cuda_device), [p.to(cuda_device) for p in p4]
    g = torch.rand(pshape, device=cuda_device)
    before = dict(bk.LAUNCHES)
    torch.testing.assert_close(bk.binsplat_fwd(a4, *p4),
                               bk.window_fwd_plain(a4, *p4),
                               atol=VALUE_ATOL, rtol=0)
    for got, want in zip(bk.binsplat_bwd(a4, *p4, g),
                         bk.window_bwd_plain(a4, *p4, g)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    assert bk.LAUNCHES == {k: before[k] + 1 for k in before}


@pytest.mark.cuda
def test_bin_window_on_gpu_matches_cpu(cuda_device):
    """splat_binned_window's value and gradients (BinWindow: K4 forward,
    K5 backward) on the GPU against the plain versions on the CPU."""
    p_b, a_b, bn, K, shape = _bins("drift", seed=3)
    h = torch.rand(shape)
    outs = {}
    for dev in ("cpu", cuda_device):
        p = p_b.to(dev).clone().requires_grad_(True)
        a = a_b.to(dev).clone().requires_grad_(True)
        out = bk.splat_binned_window(p, a, bn.valid.to(dev), shape, K)
        (out * h.to(dev)).sum().backward()
        outs[str(dev)] = [t.detach().cpu() for t in (out, p.grad, a.grad)]
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(gpu[0], cpu[0], atol=VALUE_ATOL, rtol=0)
    torch.testing.assert_close(gpu[1], cpu[1], atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(gpu[2], cpu[2], atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_binsplat_wrappers_refuse_bad_inputs(cuda_device):
    a = torch.zeros((2, 6, 5, 7), device=cuda_device)
    with pytest.raises(ValueError):  # positions on the CPU
        bk.binsplat_fwd(a, a.cpu(), a, a)
    with pytest.raises(TypeError):
        bk.binsplat_bwd(a, a, a, a, torch.zeros((6, 5, 7),
                                                device=cuda_device).half())
