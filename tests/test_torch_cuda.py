"""CUDA kernels K1-K5 and K3b of nfs_tpu_torch against their plain
versions, on the GPU. Every test here needs a CUDA device and skips
without one.

This file imports no JAX, so it also runs where only the port and torch
are installed; tests/conftest.py imports JAX, so there run it as
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

Tolerances: values atol 1e-5, gradients atol 1e-4 (float32 sums of the
same terms in another order; K2's plain twin scatters with atomics).
"""

import ctypes

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


_ADVECT_WRAPPERS = {
    "fwd": lambda f, g, v: ak.advect_fwd(f, v, 2.0),
    "bwd_field": lambda f, g, v: ak.advect_bwd_field(v, g, 2.0),
    "bwd_vel": lambda f, g, v: ak.advect_bwd_vel(f, v, g, 2.0),
    "bwd_fused": lambda f, g, v: ak.advect_bwd_fused(f, v, g, 2.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(_ADVECT_WRAPPERS))
@pytest.mark.parametrize("bad,error", [
    ("vel on the cpu", ValueError), ("vel not contiguous", ValueError),
    ("field half", TypeError), ("vel short", ValueError),
    ("g float64", TypeError)])
def test_wrappers_refuse_bad_inputs(cuda_device, key, bad, error):
    """Each advection wrapper refuses a wrong device, layout, type or
    shape of any of its tensors, and launches nothing."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", 2.0))
    if bad == "vel on the cpu":
        v = v.cpu()
    elif bad == "vel not contiguous":
        v = v.transpose(0, 2).contiguous().transpose(0, 2)
    elif bad == "field half":
        f, g = f.half(), g.half()
    elif bad == "vel short":
        v = v[..., :2].contiguous()
    else:
        f, g = f.double(), g.double()
    before = dict(ak.LAUNCHES)
    with pytest.raises(error):
        _ADVECT_WRAPPERS[key](f, g, v)
    assert ak.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("max_disp", [0.5, 2.0, 3.0, 8.0])
@pytest.mark.parametrize("shape", [(62, 36, 62), (35, 20, 35), (1, 7, 9),
                                   (5, 1, 3), (4, 6, 1)]
                         + [(3, 4, w) for w in range(1, 10)])
def test_k1_on_ragged_shapes(cuda_device, shape, max_disp):
    """K1 (a run of cells along z per thread) on the octave shapes, on
    axes of one cell and on every W from 1 to 9, at max_disp 0.5 to 8:
    against its plain twin, and two launches bitwise equal."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", max_disp, shape, seed=7))
    out = ak.advect_fwd(f, v, max_disp)
    torch.testing.assert_close(out, ak.advect_fwd_plain(f, v, max_disp),
                               atol=VALUE_ATOL, rtol=0)
    assert torch.equal(out, ak.advect_fwd(f, v, max_disp))


@pytest.mark.cuda
def test_k1_refuses_shapes_past_32_bit_indices(cuda_device):
    """K1 indexes a plane and a column of planes with 32-bit integers:
    its entry point refuses H * W or D * H past INT_MAX before it
    launches (the pointers are never read)."""
    lib = ctypes.CDLL(str(ak.build_library()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nfs_advect_fwd.argtypes = [p, p, p, i, i, i, i, ctypes.c_float, i,
                                   p]
    big = 1 << 16
    for shape in ((1, big, big), (big, big, 1)):
        assert lib.nfs_advect_fwd(None, None, None, 1, *shape, 2.0,
                                  cuda_device.index, None) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("max_disp", [12.0, 40.0])
def test_k1_any_max_disp(cuda_device, max_disp):
    """K1 stages nothing, so it takes any max_disp, past K2's limit too."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", max_disp, (13, 7, 37), seed=9))
    torch.testing.assert_close(ak.advect_fwd(f, v, max_disp),
                               ak.advect_fwd_plain(f, v, max_disp),
                               atol=VALUE_ATOL, rtol=0)


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
    """Every radius runs on the card: K2 on its tile below BINNED_FROM_R
    and by its binned route from there; K3b on its tile to R = 7 (the
    largest on a shrunk tile) and as K2 + K3 past it (counting their
    launches, not K3b's)."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", max(R, 0.5), (13, 7, 37), seed=R))
    md = float(R)
    before = dict(ak.LAUNCHES)
    torch.testing.assert_close(ak.advect_bwd_field(v, g, md),
                               ak.advect_bwd_field_plain(v, g, md),
                               atol=GRAD_ATOL, rtol=0)
    k2 = "bwd_field" if R < ak.BINNED_FROM_R else "bwd_field_binned"
    assert ak.LAUNCHES == dict(before, **{k2: before[k2] + 1})
    before = dict(ak.LAUNCHES)
    for got, want in zip(ak.advect_bwd_fused(f, v, g, md),
                         ak.advect_bwd_fused_plain(f, v, g, md)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    if R <= 7:
        launched = {"bwd_fused": before["bwd_fused"] + 1}
    else:
        launched = {k2: before[k2] + 1, "bwd_vel": before["bwd_vel"] + 1}
    assert ak.LAUNCHES == dict(before, **launched)


def _untiled(v, g, max_disp):
    """K2's untiled pull launched through its operator at any radius."""
    return ak.load_library().advect_bwd_field_untiled(
        v, g, max_disp, ak._radius(max_disp))


@pytest.mark.cuda
@pytest.mark.parametrize("max_disp", [9.0, 12.0])
@pytest.mark.parametrize("shape", [(24, 16, 40), (5, 1, 3), (1, 7, 9)])
def test_k2_untiled_past_the_plan(cuda_device, shape, max_disp):
    """Past the tile plan K2 takes its binned route: against its plain
    twin, on axes shorter than the radius too, bitwise the untiled pull
    called through its operator, and two launches bitwise equal; K3b's
    wrapper there equals K2 + K3 exactly."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", max_disp, shape, seed=11))
    before = dict(ak.LAUNCHES)
    gf = ak.advect_bwd_field(v, g, max_disp)
    assert ak.LAUNCHES["bwd_field_binned"] == \
        before["bwd_field_binned"] + 1
    torch.testing.assert_close(gf, ak.advect_bwd_field_plain(v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)
    assert torch.equal(gf, _untiled(v, g, max_disp))
    assert torch.equal(gf, ak.advect_bwd_field(v, g, max_disp))
    fused = ak.advect_bwd_fused(f, v, g, max_disp)
    assert torch.equal(fused[0], gf)
    assert torch.equal(fused[1], ak.advect_bwd_vel(f, v, g, max_disp))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "integer", "zero"])
@pytest.mark.parametrize("max_disp", [0.5, 2.0, 3.0, 5.0, 8.0])
def test_k2_untiled_same_bits_as_tiled(cuda_device, max_disp, kind):
    """Wherever the tile plan reaches (R <= 8), the untiled pull and the
    binned route called through their operators give the tiled pull's
    bits: the same terms in the same order, the zero-weight ones that one
    adds and another does not adding +-0; the wrapper gives them too."""
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(kind, max_disp, (13, 7, 37), seed=12))
    tiled = _pull_on_tile(f, g, v, max_disp,
                          ak._pull_plan(ak._radius(max_disp))[:3], False)[0]
    assert torch.equal(_untiled(v, g, max_disp), tiled)
    assert torch.equal(ak._binned_route(v, g, max_disp), tiled)
    assert torch.equal(ak.advect_bwd_field(v, g, max_disp), tiled)


@pytest.mark.cuda
@pytest.mark.parametrize("max_disp", [1.0, 2.0, 9.0, 12.0])
@pytest.mark.parametrize("shape", [(24, 16, 40), (5, 1, 3), (1, 7, 9),
                                   (1, 1, 1)])
def test_k2_binned_route_pieces(cuda_device, shape, max_disp):
    """The binned route's key pass gives its plain twin's keys and
    records bitwise, clamped walls too; its gather from the plain twin's
    sorted layout gives the route's bits and the untiled pull's; a batch
    of 3 frames is one sort and gives three single routes' bits."""
    f, g, v = _inputs("random", max_disp, shape, seed=16)
    v = np.where(np.random.default_rng(17).random(v.shape) < 0.3,
                 _walls(shape, seed=18), v).astype(np.float32)
    f, g, v = (torch.from_numpy(a).to(cuda_device) for a in (f, g, v))
    ops = ak.load_library()
    keys, rec = ops.advect_bin_sources(v, g, max_disp)
    want_keys, want_rec = ak.bin_sources_plain(v, g, max_disp)
    assert torch.equal(keys, want_keys) and torch.equal(rec, want_rec)
    gf = ops.advect_bwd_field_binned(rec, *ak.order_sources(keys))
    assert torch.equal(gf, ak._binned_route(v, g, max_disp))
    assert torch.equal(gf, _untiled(v, g, max_disp))
    torch.testing.assert_close(
        gf, ak.advect_bwd_field_binned_plain(v, g, max_disp),
        atol=GRAD_ATOL, rtol=0)
    vb = torch.stack([v, v.flip(0), 0.5 * v])
    gb = torch.stack([g, -g, 2.0 * g])
    assert torch.equal(ak._binned_route(vb, gb, max_disp), torch.stack(
        [ak._binned_route(vb[b], gb[b], max_disp) for b in range(3)]))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("max_disp", [9.0, 12.0])
def test_advect_past_the_plan_on_gpu_matches_cpu(cuda_device, monkeypatch,
                                                 max_disp, fused):
    """advect at max_disp 9 and 12, with and without FUSED_BWD, returns on
    the GPU the value and both gradients of the same call on the CPU
    (plain twins) instead of raising; K3b is not launched past its plan."""
    monkeypatch.setattr(ak, "FUSED_BWD", fused)
    f, g, v = _inputs("random", max_disp, (20, 12, 28), seed=13)
    outs = {}
    for dev in ("cpu", cuda_device):
        ft = torch.tensor(f, device=dev, requires_grad=True)
        vt = torch.tensor(v, device=dev, requires_grad=True)
        before = dict(ak.LAUNCHES)
        out = advect(ft, vt, max_disp=max_disp)
        (out * torch.tensor(g, device=dev)).sum().backward()
        launched = {k: ak.LAUNCHES[k] - before[k] for k in before}
        outs[str(dev)] = [t.detach().cpu() for t in (out, ft.grad, vt.grad)]
    assert launched == {"fwd": 1, "bwd_field": 0, "bwd_field_binned": 1,
                        "bwd_vel": 1, "bwd_fused": 0}
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(gpu[0], cpu[0], atol=VALUE_ATOL, rtol=0)
    torch.testing.assert_close(gpu[1], cpu[1], atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(gpu[2], cpu[2], atol=GRAD_ATOL, rtol=0)


def _walls(shape, seed):
    """Displacements that clamp most backtraces to exactly 0 or n - 1 (a
    component of +-(n + 3) cells), the others random."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(tuple(shape) + (3,)).astype(np.float32)
    push = rng.random(v.shape) < 0.7
    size = np.array(shape, np.float32) + 3.0
    v = np.where(push, np.sign(v) * size, v).astype(np.float32)
    return v


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["walls", "random", "integer"])
@pytest.mark.parametrize("shape", [(24, 16, 40), (35, 20, 35), (1, 7, 9),
                                   (5, 1, 3), (4, 6, 1), (1, 1, 1)]
                         + [(3, 4, w) for w in range(1, 10)])
def test_k3_clamped_and_ragged(cuda_device, shape, kind):
    """K3 (a run of cells along z per thread, taps outside the grid read
    as 0) against its plain twin where backtraces clamp to exactly 0 and
    n - 1 (the out-of-grid tap's derivative there is -+0.5), on one-cell
    axes and every W from 1 to 9; two launches bitwise equal, and equal
    to K3b's gradient wrt s."""
    md = max(shape) + 3.0 if kind == "walls" else 2.0
    f, g, v = _inputs("random", md, shape, seed=14)
    if kind == "walls":
        v = _walls(shape, seed=15)
    elif kind == "integer":
        v = np.round(v)
    f, g, v = (torch.from_numpy(a).to(cuda_device) for a in (f, g, v))
    if kind == "walls":
        s = ak.backtrace(v, md)
        n = torch.tensor(shape, device=cuda_device, dtype=torch.float32)
        at_wall = sum(((s[a] == 0) | (s[a] == n[a] - 1)).float().mean()
                      for a in range(3)) / 3
        assert float(at_wall) > 0.5
    gs = ak.advect_bwd_vel(f, v, g, md)
    torch.testing.assert_close(gs, ak.advect_bwd_vel_plain(f, v, g, md),
                               atol=GRAD_ATOL, rtol=0)
    assert torch.equal(gs, ak.advect_bwd_vel(f, v, g, md))
    if ak._pull_plan(ak._radius(md), fused=True) is not None:
        assert torch.equal(gs, ak.load_library().advect_bwd_fused(
            f, v, g, md, ak._radius(md),
            *ak._pull_plan(ak._radius(md), fused=True))[1])


@pytest.mark.cuda
@pytest.mark.parametrize("entry,argtypes,args", [
    ("nfs_advect_bwd_vel", "pppp iiii f i p",
     (None,) * 4 + (1, 1, 1 << 16, 1 << 16, 2.0, 0, None)),
    ("nfs_advect_bwd_field_untiled", "ppp iiii f i i p",
     (None,) * 3 + (1, 1 << 16, 1 << 16, 1, 9.0, 9, 0, None)),
    ("nfs_advect_bwd_field_untiled", "ppp iiii f i i p",
     (None,) * 3 + (1, 2, 3, 4, 9.0, -1, 0, None)),
    # the binned route numbers the batch's cells with 32-bit integers
    ("nfs_advect_bin_sources", "pppp iiii f i p",
     (None,) * 4 + (2, 1 << 10, 1 << 10, 1 << 10, 9.0, 0, None)),
    ("nfs_advect_bwd_field_binned", "pppp iiii i p",
     (None,) * 4 + (1, 1 << 11, 1 << 10, 1 << 10, 0, None)),
    ("nfs_advect_bwd_field_binned", "pppp iiii i p",
     (None,) * 4 + (-1, 2, 3, 4, 0, None)),
    # a batch past the grid's 65 535 blocks along z, or a negative one
    ("nfs_advect_fwd", "ppp iiii f i p",
     (None,) * 3 + (1 << 16, 1, 7, 9, 2.0, 0, None)),
    ("nfs_advect_bwd_field", "ppp iiii f iiiii i p",
     (None,) * 3 + (1 << 16, 1, 7, 9, 2.0, 2, 4, 8, 24, 17_000, 0, None)),
    ("nfs_advect_bwd_vel", "pppp iiii f i p",
     (None,) * 4 + (-1, 2, 3, 4, 2.0, 0, None)),
    ("nfs_binsplat_bwd", "ppppppppp iiiii i p",
     (None,) * 9 + (1, 1 << 10, 1 << 10, 1 << 10, 2, 0, None)),
    # a keyframe batch past the grid's 65 535 blocks (K4 along z, K5
    # along y), or a negative one
    ("nfs_binsplat_fwd", "ppppp iiiii i p",
     (None,) * 5 + (1 << 15, 1, 8, 4, 30, 0, None)),
    ("nfs_binsplat_bwd", "ppppppppp iiiii i p",
     (None,) * 9 + (1 << 16, 1, 2, 3, 4, 0, None)),
    ("nfs_binsplat_bwd", "ppppppppp iiiii i p",
     (None,) * 9 + (-1, 1, 2, 3, 4, 0, None)),
])
def test_entry_points_refuse_past_32_bit_indices(cuda_device, entry,
                                                 argtypes, args):
    """K3, the untiled and binned K2 and K5 index with 32-bit integers:
    their entry points refuse a shape past that (and the untiled K2 a
    negative radius) before they launch; so do K1, K2, K4 and K5 a batch past the
    grid's limit and K3 and K5 a negative batch. The pointers are never
    read."""
    lib = ctypes.CDLL(str((bk if "binsplat" in entry else ak)
                          .build_library()))
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    fn = getattr(lib, entry)
    fn.argtypes = [types[c] for c in argtypes.replace(" ", "")]
    assert fn(*args) != 0


def _pull_on_tile(f, g, v, max_disp, tile, fused):
    """K2 (``fused=False``) or K3b launched through its operator on a
    given (TZ, TY, TX) tile instead of the plan's."""
    ops = ak.load_library()
    R = ak._radius(max_disp)
    nbytes = ak._staged_bytes(R, tile, fused)
    if not fused:
        return (ops.advect_bwd_field(v, g, max_disp, R, *tile, nbytes),)
    return ops.advect_bwd_fused(f, v, g, max_disp, R, *tile, nbytes)


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
    assert bk.LAUNCHES == dict(before, fwd=before["fwd"] + 1,
                               bwd=before["bwd"] + 1)


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


def _bin_window(x, shape, K, seed=0):
    """(a4, [p_z, p_y, p_x]) of particles ``x`` binned at ``shape`` with
    capacity K, on the CPU, as the styler's window sees them."""
    rng = np.random.default_rng(seed)
    bn = B.bin_particles(torch.from_numpy(x), shape, K)
    p_b = B.to_binned(bn, torch.from_numpy(x))
    a_b = B.to_binned(bn, torch.from_numpy(
        (0.5 + rng.random(len(x))).astype(np.float32)))
    pshape = B.padded_shape(shape)
    n_slots = bn.valid.shape[0]
    a4 = torch.where(bn.valid, a_b[:n_slots], 0.0).view((K,) + pshape)
    p4 = [p_b[d, :n_slots].view((K,) + pshape).contiguous()
          for d in range(3)]
    return a4, p4


def _check_k4(a4, p4, device):
    a4, p4 = a4.to(device), [p.to(device) for p in p4]
    out = bk.binsplat_fwd(a4, *p4)
    torch.testing.assert_close(out, bk.window_fwd_plain(a4, *p4),
                               atol=VALUE_ATOL, rtol=0)
    assert torch.equal(out, bk.binsplat_fwd(a4, *p4))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", [(20, 14, 24), (7, 5, 9), (3, 1, 11),
                                   (1, 1, 1)])
def test_k4_ranks_and_ragged_grids(cuda_device, K, shape):
    """K4 (a row of cells along x per warp, a column along z per lane) at
    K = 1 to 8 on padded grids that are not multiples of its launch, with
    crowded cells so that every rank holds particles: against its plain
    version, and two launches bitwise equal."""
    rng = np.random.default_rng(K)
    n = 4 * int(np.prod(shape))
    x = (rng.random((n, 3)) * (np.array(shape) - 1)).astype(np.float32)
    _check_k4(*_bin_window(x, shape, K), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rank 0 only", "all empty",
                                  "nan in empty slots"])
def test_k4_sparse_bins(cuda_device, case):
    """K4 where whole ranks, or all bins, are empty: one particle per
    cell (rank 0 only), no particle (exact zeros), and NaN positions in
    every empty slot, which leave the result's bits as they were (finite,
    exact zeros where no particle reaches)."""
    shape, K = (12, 9, 30), 4
    x = (np.stack(np.meshgrid(*[np.arange(0, s, 3) for s in shape],
                              indexing="ij"), -1).reshape(-1, 3)
         + 0.3).astype(np.float32)
    if case == "all empty":
        x = x[:0]
    a4, p4 = _bin_window(x, shape, K)
    out = _check_k4(a4, p4, cuda_device)
    assert bool(torch.isfinite(out).all())
    if case == "all empty":
        assert torch.equal(out, torch.zeros_like(out))
    else:
        assert bool((a4[1:] == 0).all())
    if case == "nan in empty slots":
        nan_p = [p.clone() for p in p4]
        for p in nan_p:
            p[a4 == 0] = float("nan")
        nan_p = [p.to(cuda_device) for p in nan_p]
        assert torch.equal(bk.binsplat_fwd(a4.to(cuda_device), *nan_p), out)


@pytest.mark.cuda
def test_k4_rank_skip_same_bits_as_filled_tiles(cuda_device):
    """A row of slots that holds no particle in the whole warp is skipped
    (rank 2 here, everywhere). The same bins with that rank filled in
    every slot by particles whose weights are all exactly 0 (a != 0, the
    particle far from its bin) run every row of every rank and add only
    +0: the bits must be the same."""
    shape, K = (20, 14, 24), 3
    rng = np.random.default_rng(4)
    x = (rng.random((600, 3)) * (np.array(shape) - 1)).astype(np.float32)
    a4, p4 = _bin_window(x, shape, K)
    assert bool((a4[2] == 0).all())    # rank 2 empty: skipped everywhere
    filled_a, filled_p = a4.clone(), [p.clone() for p in p4]
    filled_a[2] = 1.0
    for p in filled_p:
        p[2] = 1.0e4
    skipped = _check_k4(a4, p4, cuda_device)
    assert torch.equal(_check_k4(filled_a, filled_p, cuda_device), skipped)


@pytest.mark.cuda
def test_k4_refuses_shapes_past_32_bit_indices(cuda_device):
    """K4 indexes a slot's plane row with 32-bit integers: its entry
    point refuses Z * Y past INT_MAX before it launches (the pointers are
    never read)."""
    lib = ctypes.CDLL(str(bk.build_library()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nfs_binsplat_fwd.argtypes = [p] * 5 + [i] * 5 + [i, p]
    assert lib.nfs_binsplat_fwd(None, None, None, None, None, 1, 1,
                                1 << 16, 1 << 16, 1, cuda_device.index,
                                None) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("positions on the cpu", ValueError), ("a half", TypeError),
    ("p_y short", ValueError), ("p_x not contiguous", ValueError),
    ("a 3d", ValueError), ("g half", TypeError), ("g short", ValueError)])
def test_binsplat_wrappers_refuse_bad_inputs(cuda_device, bad, error):
    """K4's and K5's wrappers refuse a wrong device, type, shape, rank or
    layout of any of their tensors, and launch nothing."""
    a = torch.zeros((2, 6, 5, 7), device=cuda_device)
    p = [torch.zeros_like(a) for _ in range(3)]
    g = torch.zeros((6, 5, 7), device=cuda_device)
    if bad == "positions on the cpu":
        p[0] = p[0].cpu()
    elif bad == "a half":
        a = a.half()
    elif bad == "p_y short":
        p[1] = p[1][:, :5].contiguous()
    elif bad == "p_x not contiguous":
        p[2] = p[2].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "a 3d":
        a = a[0]
    elif bad == "g half":
        g = g.half()
    else:
        g = g[:, :4].contiguous()
    before = dict(bk.LAUNCHES)
    with pytest.raises(error):
        bk.binsplat_bwd(a, *p, g)
    if not bad.startswith("g "):
        with pytest.raises(error):
            bk.binsplat_fwd(a, *p)
    assert bk.LAUNCHES == before


def _check_k5(a4, p4, g, device):
    """K5 against its plain version: values within GRAD_ATOL, the sign of
    every zero the plain version gives (+0, or -0 in dp where a < 0), and
    two launches bitwise equal."""
    a4, p4, g = a4.to(device), [p.to(device) for p in p4], g.to(device)
    got = bk.binsplat_bwd(a4, *p4, g)
    want = bk.window_bwd_plain(a4, *p4, g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, atol=GRAD_ATOL, rtol=0)
        zero = y == 0
        assert torch.equal(x[zero].signbit(), y[zero].signbit())
    for x, y in zip(got, bk.binsplat_bwd(a4, *p4, g)):
        assert torch.equal(x, y) and torch.equal(x.signbit(), y.signbit())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 3, 4, 7, 8, 15, 16])
def test_k5_ranks(cuda_device, K):
    """K5 at K = 1 to 16 with crowded cells, so that many ranks hold
    particles, and drifted positions."""
    shape = (13, 9, 21)
    rng = np.random.default_rng(20 + K)
    n = 3 * int(np.prod(shape))
    x = (rng.random((n, 3)) * (np.array(shape) - 1)).astype(np.float32)
    a4, p4 = _bin_window(x, shape, K, seed=K)
    p4 = [p + torch.from_numpy(rng.uniform(-0.5, 0.5, p.shape).astype(
        np.float32)) * (a4 != 0) for p in p4]
    g = torch.from_numpy(rng.standard_normal(a4.shape[1:]).astype(
        np.float32))
    _check_k5(a4, p4, g, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["garbage", "all live", "negative a"])
def test_k5_empty_live_and_signed(cuda_device, case):
    """K5 where empty slots hold arbitrary positions (uniform far around
    the grid, huge, NaN and inf), where every slot is live (each empty
    slot's position within reach of its bin, a == 0 there), and with
    negative attributes in slots no tap reaches (dp must be -0)."""
    shape, K = (12, 9, 30), 4
    rng = np.random.default_rng(30)
    x = (rng.random((2500, 3)) * (np.array(shape) - 1)).astype(np.float32)
    a4, p4 = _bin_window(x, shape, K, seed=31)
    empty = a4 == 0
    pshape = a4.shape[1:]
    bins = [torch.arange(n, dtype=torch.float32).view(
        [-1 if d == i else 1 for d in range(3)]) for i, n in enumerate(
        pshape)]
    if case == "garbage":
        for p in p4:
            junk = torch.from_numpy(rng.uniform(-60.0, 120.0, p.shape)
                                    .astype(np.float32))
            junk.view(-1)[::97] = float("nan")
            junk.view(-1)[5::101] = float("inf")
            junk.view(-1)[7::89] = -3.0e38
            p[empty] = junk[empty]
    elif case == "all live":
        for p, b in zip(p4, bins):
            p[empty] = (b + 1.0 - B.PAD).expand(p.shape)[empty]
        fr = [p + B.PAD - b for p, b in zip(p4, bins)]
        assert all(bool(((f > -1.5) & (f < 3.5)).all()) for f in fr)
    else:
        a4 = torch.where(empty, -torch.rand(a4.shape) - 0.5, a4)
        for p in p4:
            p[empty] = 1.0e4
    g = torch.from_numpy(rng.standard_normal(pshape).astype(np.float32))
    da, *dps = _check_k5(a4, p4, g, cuda_device)
    if case == "negative a":
        dead = empty.to(cuda_device)
        assert bool((da[dead] == 0).all())
        assert not bool(da[dead].signbit().any())
        assert all(bool(dp[dead].signbit().all()) for dp in dps)


# (kernel wrapper, plain twin) of K1-K3b, each called as fn(f, g, v,
# max_disp)
_BATCHED = {
    "fwd": (lambda f, g, v, d: ak.advect_fwd(f, v, d),
            lambda f, g, v, d: ak.advect_fwd_plain(f, v, d)),
    "bwd_field": (lambda f, g, v, d: ak.advect_bwd_field(v, g, d),
                  lambda f, g, v, d: ak.advect_bwd_field_plain(v, g, d)),
    "bwd_vel": (lambda f, g, v, d: ak.advect_bwd_vel(f, v, g, d),
                lambda f, g, v, d: ak.advect_bwd_vel_plain(f, v, g, d)),
    "bwd_fused": (lambda f, g, v, d: ak.advect_bwd_fused(f, v, g, d),
                  lambda f, g, v, d: ak.advect_bwd_fused_plain(f, v, g, d)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("key", sorted(_BATCHED))
@pytest.mark.parametrize("max_disp", [1.0, 2.0, 9.0])
@pytest.mark.parametrize("shape", [(13, 7, 37), (1, 7, 9), (24, 16, 40)])
def test_batched_launch_equals_single_launches(cuda_device, key, max_disp,
                                               shape):
    """A (3, D, H, W) batch is one launch of each advection kernel (K2
    from BINNED_FROM_R: its binned route; K3b past its plan: K2 + K3) and
    gives the bits of three single launches, on ragged tiles too; it
    holds against the batched plain twin."""
    frames = [tuple(torch.from_numpy(a).to(cuda_device)
                    for a in _inputs("random", max_disp, shape, seed=20 + b))
              for b in range(3)]
    f, g, v = (torch.stack(x) for x in zip(*frames))
    kernel, plain = _BATCHED[key]
    before = dict(ak.LAUNCHES)
    batched = kernel(f, g, v, max_disp)
    launched = sum(ak.LAUNCHES[k] - before[k] for k in before)
    single = [kernel(*x, max_disp) for x in frames]
    fused_split = key == "bwd_fused" and ak._pull_plan(
        ak._radius(max_disp), fused=True) is None
    assert launched == (2 if fused_split else 1)
    if not isinstance(batched, tuple):
        batched, single = (batched,), [(s,) for s in single]
    for i, got in enumerate(batched):
        assert torch.equal(got, torch.stack([s[i] for s in single]))
    ref = plain(f, g, v, max_disp)
    for got, want in zip(batched, ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_advect_window_batch_on_gpu_matches_cpu(cuda_device):
    """advect_frames on a batch: the value and both gradients on the GPU
    (one launch of K1, K2 and K3 each) equal the CPU's within the
    tolerances."""
    from nfs_tpu_torch.ops.advect import advect_frames

    rng = np.random.default_rng(21)
    f = rng.random((3, 20, 12, 28), dtype=np.float32)
    v = (1.5 * rng.standard_normal((3, 20, 12, 28, 3))).astype(np.float32)
    g = rng.standard_normal(f.shape).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        ft = torch.tensor(f, device=dev, requires_grad=True)
        vt = torch.tensor(v, device=dev, requires_grad=True)
        before = dict(ak.LAUNCHES)
        out = advect_frames(ft, vt, max_disp=2.0)
        (out * torch.tensor(g, device=dev)).sum().backward()
        launched = {k: ak.LAUNCHES[k] - before[k] for k in before}
        outs[str(dev)] = [t.detach().cpu() for t in (out, ft.grad, vt.grad)]
    assert launched == {"fwd": 1, "bwd_field": 1, "bwd_field_binned": 0,
                        "bwd_vel": 1, "bwd_fused": 0}
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(gpu[0], cpu[0], atol=VALUE_ATOL, rtol=0)
    for a, b in zip(gpu[1:], cpu[1:]):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("shape", [(20, 14, 24), (7, 5, 9), (3, 1, 11)])
def test_binsplat_batched_launch_equals_single_launches(cuda_device, shape,
                                                        K):
    """A batch of 3 keyframes' (K, Zp, Yp, Xp) bins is one launch of K4
    and one of K5 and gives the bits of three single launches (the zero
    signs too), on ragged grids; it holds against the batched plain
    twins."""
    rng = np.random.default_rng(40 + K)
    n = 2 * int(np.prod(shape))
    frames = [_bin_window((rng.random((n, 3)) * (np.array(shape) - 1))
                          .astype(np.float32), shape, K, seed=b)
              for b in range(3)]
    a5 = torch.stack([a for a, _ in frames]).to(cuda_device)
    p5 = [torch.stack([p[d] for _, p in frames]).to(cuda_device)
          for d in range(3)]
    g = torch.from_numpy(rng.standard_normal(
        (3,) + tuple(a5.shape[2:])).astype(np.float32)).to(cuda_device)
    before = dict(bk.LAUNCHES)
    fwd = bk.binsplat_fwd(a5, *p5)
    bwd = bk.binsplat_bwd(a5, *p5, g)
    assert {k: bk.LAUNCHES[k] - before[k] for k in before} == {
        "fwd": 1, "bwd": 1, "color_fwd": 0, "color_bwd": 0}
    for b in range(3):
        p4 = [p[b] for p in p5]
        assert torch.equal(fwd[b], bk.binsplat_fwd(a5[b], *p4))
        for got, want in zip(bwd, bk.binsplat_bwd(a5[b], *p4, g[b])):
            assert torch.equal(got[b], want)
            assert torch.equal(got[b].signbit(), want.signbit())
    torch.testing.assert_close(fwd, bk.window_fwd_plain(a5, *p5),
                               atol=VALUE_ATOL, rtol=0)
    for got, want in zip(bwd, bk.window_bwd_plain(a5, *p5, g)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_batched_bin_window_on_gpu_matches_cpu(cuda_device):
    """splat_binned_window of a keyframe batch on the GPU (one K4 and one
    K5 launch) against the same batch on the CPU: value and gradients
    wrt positions and attributes."""
    shape, K = (12, 9, 14), 4
    rng = np.random.default_rng(50)
    xs = (rng.random((3, 1500, 3)) * (np.array(shape) - 1)).astype(
        np.float32)
    attr = (0.5 + rng.random((3, 1500))).astype(np.float32)
    h = rng.standard_normal((3,) + shape).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        bn = B.bin_particles(torch.from_numpy(xs).to(dev), shape, K)
        p_b = B.to_binned(bn, torch.from_numpy(xs).to(dev)
                          ).requires_grad_(True)
        a_b = B.to_binned(bn, torch.from_numpy(attr).to(dev)
                          ).requires_grad_(True)
        before = dict(bk.LAUNCHES)
        out = bk.splat_binned_window(p_b, a_b, bn.valid, shape, K)
        (out * torch.from_numpy(h).to(dev)).sum().backward()
        launched = {k: bk.LAUNCHES[k] - before[k] for k in before}
        outs[str(dev)] = [t.detach().cpu() for t in (out, p_b.grad,
                                                    a_b.grad)]
    assert launched == {"fwd": 1, "bwd": 1, "color_fwd": 0, "color_bwd": 0}
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(gpu[0], cpu[0], atol=VALUE_ATOL, rtol=0)
    for a, b in zip(gpu[1:], cpu[1:]):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)
