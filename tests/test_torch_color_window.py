"""LNST's colour pass through the five-channel window kernels K4c/K5c
(``binsplat_kernels.BinColorWindow``, ``splat_binned_color_window``).

On the CPU the wrappers run the plain twins, which are held against the
generic 5-channel pass (``ops.binsplat._splat_binned`` over [density,
colour clipped to [0, 1], ones], as ``splat_binned_color`` runs it); the
``cuda`` cases hold the kernels against the twins on the card, at small
sizes and at the finest octave of particles_3d (96x64x96, 200 000
particles, K = 8). This file imports no JAX, so on a card run it as
``python -m pytest --noconftest -q tests/test_torch_color_window.py``.

Tolerances: values atol 1e-5, gradients atol 1e-4, as
``tests/test_torch_binsplat.py`` holds K4/K5: float32 sums of the same
terms in another order (the twins sum each tap over K, then the taps;
K4c sums each rank's taps, then the ranks; the generic pass's autograd
forms the position gradient channel by channel, the twins and K5c fold
the five channels into one cotangent a tap first). Measured on the CPU:
values equal bit for bit, gradients within 1e-6.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.ops import binsplat as TB
from nfs_tpu_torch.ops import binsplat_kernels as BK
from nfs_tpu_torch.ops.jaxgrad import jax_clip
from nfs_tpu_torch.styler import particle as TP

torch.set_num_threads(2)

VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4
# the finest octave of particles_3d, as lnst3d.color runs it
FINEST = ((96, 64, 96), 200_000, 8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _particles(shape, n, seed, cluster=0):
    """(x, dens, color): n particles over the grid and a margin past it,
    ``cluster`` of them in one base cell (so high ranks fill and some
    park), colours from -0.2 to 1.2 with a tenth of each channel tied at
    0 or 1 (the clip's 0.5 subgradient)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, 3)) * (np.asarray(shape) + 2.0) - 1.0
    x[:cluster] = 4.0 + 0.05 * rng.random((cluster, 3))
    color = rng.uniform(-0.2, 1.2, (n, 3))
    for c in range(3):
        ties = rng.random(n) < 0.1
        color[ties, c] = rng.integers(0, 2, int(ties.sum()))
    dens = 0.5 + rng.random(n)
    return (torch.tensor(x, dtype=torch.float32),
            torch.tensor(dens, dtype=torch.float32),
            torch.tensor(color, dtype=torch.float32))


def _bins(shape, K, n=900, seed=0, cluster=40, device="cpu"):
    """(p_b, dens_b, color_b, valid) of particles binned at capacity K and
    moved by up to 0.45 cells after binning, as the styler's offsets move
    them between rebins."""
    x, dens, color = _particles(shape, n, seed, cluster)
    bn = TB.bin_particles(x, shape, K)
    moved = x + torch.from_numpy(np.random.default_rng(seed + 1).uniform(
        -0.45, 0.45, tuple(x.shape)).astype(np.float32))
    return tuple(t.to(device) for t in (
        TB.to_binned(bn, moved), TB.to_binned(bn, dens),
        TB.to_binned(bn, color), bn.valid))


def _cotangents(shape, seed, lead=()):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(lead + shape)
                             .astype(np.float32)),
            torch.from_numpy(rng.standard_normal(lead + shape + (3,))
                             .astype(np.float32)))


def _pass(fn, bins, shape, K, h):
    """fn's density and colour grids and the gradients of <grids, h> wrt
    positions, densities and colours."""
    p, d, c = (t.detach().clone().requires_grad_(True) for t in bins[:3])
    dg, cg = fn(p, d, c, bins[3], shape, K)
    loss = (dg * h[0].to(dg.device)).sum() + (cg * h[1].to(dg.device)).sum()
    return [dg.detach(), cg.detach(), *torch.autograd.grad(loss, (p, d, c))]


def _assert_close(got, want):
    torch.testing.assert_close(got[0], want[0], atol=VALUE_ATOL, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=VALUE_ATOL, rtol=0)
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, atol=GRAD_ATOL, rtol=0)


def _garbage(bins):
    """The bins with NaN, inf and huge values in every slot that is not
    valid, dense or parking: nothing there may reach a result."""
    p, d, c, valid = (t.clone() for t in bins)
    S, n_slots = p.shape[-1], valid.shape[-1]
    dead = torch.cat([~valid, torch.ones(valid.shape[:-1] + (S - n_slots,),
                                         dtype=torch.bool,
                                         device=valid.device)], dim=-1)
    junk = torch.tensor([float("nan"), float("inf"), -1e30, 7.0],
                        device=p.device).repeat(S // 4 + 1)[:S]
    p = torch.where(dead[..., None, :], junk, p)
    c = torch.where(dead[..., None, :], -junk, c)
    d = torch.where(dead, junk, d)
    return (p, d, c, valid), dead


# --------------------------------------------------------------------- #
# CPU: the plain twins against the generic pass
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("K", [1, 2, 5, 8, 16])
def test_twins_match_the_generic_pass(K):
    """Raw 5-channel splat and the normalized pass, value and gradients
    wrt positions, densities and colours, from K = 1 (most particles
    parked) to K = 16 (the cluster fills every rank); colours tied at 0
    and 1 take the clip's 0.5."""
    shape = (10, 8, 12)
    bins = _bins(shape, K, seed=K)
    p, d, c, valid = bins
    attr = torch.cat([d[None], jax_clip(c, 0.0, 1.0), torch.ones_like(d)[None]])
    torch.testing.assert_close(
        BK.binsplat_color_fwd(p, d, c, valid, K, shape),
        TB._splat_binned(p, attr, valid, shape, K, "bspline"),
        atol=VALUE_ATOL, rtol=0)
    h = _cotangents(shape, seed=K)
    got = _pass(BK.splat_binned_color_window, bins, shape, K, h)
    want = _pass(TB.splat_binned_color, bins, shape, K, h)
    _assert_close(got, want)
    # the ties reached the clip's subgradient
    tied = (c == 0.0) | (c == 1.0)
    assert tied.any() and (got[4][tied] != 0).any()
    torch.testing.assert_close(got[4][tied], want[4][tied], atol=GRAD_ATOL,
                               rtol=0)


def test_invalid_and_parked_slots_get_exactly_zero():
    """Garbage (NaN, inf, huge) in the slots that are not valid and in the
    parking slots changes no value, and those slots' seven gradients are
    exactly +0."""
    shape, K = (10, 8, 12), 2
    bins = _bins(shape, K, seed=5)
    dirty, dead = _garbage(bins)
    h = _cotangents(shape, seed=5)
    clean = _pass(BK.splat_binned_color_window, bins, shape, K, h)
    got = _pass(BK.splat_binned_color_window, dirty, shape, K, h)
    assert torch.equal(got[0], clean[0]) and torch.equal(got[1], clean[1])
    for g, w in zip(got[2:], clean[2:]):
        zero = g[..., dead]
        assert torch.equal(zero, torch.zeros_like(zero))
        assert not zero.signbit().any()
        assert torch.equal(g[..., ~dead], w[..., ~dead])


def test_a_keyframe_batch_is_each_keyframes_single_call():
    """A batch of three keyframes binned in one pass at their own
    capacities: the twins and the pass give each keyframe's single-call
    bits."""
    shape, K = (10, 8, 12), 4
    cap = (4, 2, 3)
    xs, dens, cols = zip(*(_particles(shape, 700, seed=20 + b, cluster=30)
                           for b in range(3)))
    xs, dens, cols = torch.stack(xs), torch.stack(dens), torch.stack(cols)
    batch = TB.bin_particles(xs, shape, K, capacity=torch.tensor(cap))
    # the batch's valid is a view of a longer row: the Function takes it
    # as it is, the wrappers contiguous
    bins = (TB.to_binned(batch, xs), TB.to_binned(batch, dens),
            TB.to_binned(batch, cols), batch.valid.contiguous())
    h = _cotangents(shape, seed=3, lead=(3,))
    g5 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3,) + shape + (5,)).astype(np.float32))
    fwd = BK.binsplat_color_fwd(*bins, K, shape)
    bwd = BK.binsplat_color_bwd(*bins, g5, K)
    out = _pass(BK.splat_binned_color_window, bins[:3] + (batch.valid,),
                shape, K, h)
    for b in range(3):
        single = [t[b] for t in bins]
        assert torch.equal(fwd[b], BK.binsplat_color_fwd(*single, K, shape))
        for got, want in zip(bwd, BK.binsplat_color_bwd(*single, g5[b], K)):
            assert torch.equal(got[b], want)
        one = _pass(BK.splat_binned_color_window, single, shape, K,
                    (h[0][b], h[1][b]))
        for got, want in zip(out, one):
            assert torch.equal(got[b], want)


def _styler_frame(monkeypatch, grid, kernel, impl):
    """One colour keyframe on the CPU; returns the calls of each colour
    route and of the generic pass's body."""
    calls = {"window": 0, "generic": 0, "_splat_binned": 0}

    def counted(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(TP, "splat_binned_color_window", counted(
        "window", TP.splat_binned_color_window))
    monkeypatch.setattr(TP, "splat_binned_color", counted(
        "generic", TP.splat_binned_color))
    monkeypatch.setattr(TB, "_splat_binned", counted(
        "_splat_binned", TB._splat_binned))
    cfg = {"render.render_size": (32, 32), "render.min_render_size": 16,
           "render.n_views": 2, "render.view_pool": 4,
           "render.transmit": 0.5, "loss.style_layers": ("relu1_1",),
           "loss.style_layer_weights": (1.0,), "loss.w_style": 1000.0,
           "optim.octave_n": 1, "optim.iters": 2,
           "particle.optimize_color": True, "particle.kernel": kernel,
           "particle.splat_impl": impl}
    rng = np.random.default_rng(7)
    n = 300
    x = (rng.random((n, len(grid))) * (np.asarray(grid) - 4.0) + 2.0)
    styler = TP.ParticleStyler(
        replace(StyleConfig(), **cfg), grid_shape=grid,
        style_image=rng.random((32, 32, 3), dtype=np.float32), device="cpu")
    styled, _, _ = styler.stylize_frame(ParticleSet(
        x=x.astype(np.float32), dens=np.ones(n, np.float32),
        color=rng.random((n, 3), dtype=np.float32)))
    assert np.isfinite(styled.color.numpy()).all()
    return calls


@pytest.mark.parametrize("grid,kernel,impl,route", [
    ((16, 12, 16), "bspline", "auto", "window"),
    ((16, 12, 16), "bspline", "binned_pallas", "window"),
    ((16, 12, 16), "bspline", "binned", "generic"),
    ((16, 12, 16), "linear", "auto", "generic"),
    ((24, 20), "bspline", "auto", "generic")],
    ids=["3d-auto", "3d-binned_pallas", "3d-binned", "3d-linear", "2d"])
def test_the_route_follows_grid_kernel_and_impl(monkeypatch, grid, kernel,
                                                impl, route):
    """3D B-spline colour with splat_impl 'auto' or 'binned_pallas' takes
    K4c/K5c and never the generic pass's body; 'binned', the linear
    kernel and 2D grids take the generic pass, one call an iteration."""
    calls = _styler_frame(monkeypatch, grid, kernel, impl)
    other = "generic" if route == "window" else "window"
    assert calls[route] == 2 and calls[other] == 0
    if route == "window":
        assert calls["_splat_binned"] == 0


@pytest.mark.parametrize("bad,error", [
    ("valid float", TypeError), ("dens half", TypeError),
    ("color short", ValueError), ("p 4d", ValueError),
    ("valid short", ValueError), ("more slots than p", ValueError),
    ("g half", TypeError), ("g short", ValueError),
    ("dens not contiguous", ValueError)])
def test_colour_wrappers_check_inputs(bad, error):
    """The wrappers refuse on CPU tensors what the operators refuse on
    CUDA ones, and launch nothing."""
    shape, K = (4, 3, 5), 2
    bins = list(_bins(shape, K, n=60, seed=1, cluster=0))
    g = torch.zeros(shape + (5,))
    if bad == "valid float":
        bins[3] = bins[3].float()
    elif bad == "dens half":
        bins[1] = bins[1].half()
    elif bad == "color short":
        bins[2] = bins[2][:2].contiguous()
    elif bad == "p 4d":
        bins[0] = bins[0][None, None]
    elif bad == "valid short":
        bins[3] = bins[3][1:].contiguous()
    elif bad == "more slots than p":
        bins = [t[..., :bins[3].shape[0] - 1].contiguous()
                for t in bins[:3]] + [bins[3]]
    elif bad == "g half":
        g = g.half()
    elif bad == "g short":
        g = g[:, :2].contiguous()
    else:
        bins[1] = torch.stack([bins[1], bins[1]], dim=1)[:, 0]
    before = dict(BK.LAUNCHES)
    with pytest.raises(error):
        BK.binsplat_color_bwd(*bins, g, K)
    if not bad.startswith("g "):
        with pytest.raises(error):
            BK.binsplat_color_fwd(*bins, K, shape)
    assert BK.LAUNCHES == before


# --------------------------------------------------------------------- #
# on the card: the kernels against the twins
# --------------------------------------------------------------------- #

def _check_kernels(bins, shape, K, g5):
    """K4c and K5c against the twins on the same device; two launches of
    each bitwise equal; one launch of each counted per call."""
    before = dict(BK.LAUNCHES)
    fwd = BK.binsplat_color_fwd(*bins, K, shape)
    bwd = BK.binsplat_color_bwd(*bins, g5, K)
    assert {k: BK.LAUNCHES[k] - before[k] for k in before} == {
        "fwd": 0, "bwd": 0, "color_fwd": 1, "color_bwd": 1}
    torch.testing.assert_close(
        fwd, BK.window_color_fwd_plain(*bins, K, shape), atol=VALUE_ATOL,
        rtol=0)
    for got, want in zip(bwd, BK.window_color_bwd_plain(*bins, g5, K)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    assert torch.equal(fwd, BK.binsplat_color_fwd(*bins, K, shape))
    for a, b in zip(bwd, BK.binsplat_color_bwd(*bins, g5, K)):
        assert torch.equal(a, b)
    return fwd, bwd


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 5, 8, 16])
def test_colour_kernels_match_the_twins(cuda_device, K):
    shape = (13, 9, 35)   # X past one warp's 30 cells, Z not a multiple of 4
    bins = _bins(shape, K, n=3000, seed=K, cluster=60, device=cuda_device)
    g5 = torch.randn(shape + (5,), device=cuda_device)
    _check_kernels(bins, shape, K, g5)


@pytest.mark.cuda
def test_colour_kernels_at_the_finest_octave(cuda_device):
    """lnst3d.color's finest octave (96x64x96, 200 000 particles, K = 8),
    with garbage in every slot that is not valid and in the parking
    slots: the values and the others' gradients of the clean bins, and
    exactly +0 in the garbage slots' gradients; a keyframe batch of two
    is each keyframe's single launch."""
    shape, n, K = FINEST
    rng = np.random.default_rng(11)
    x = torch.from_numpy((rng.random((n, 3)) * np.array([80, 48, 80])
                          + 8.0).astype(np.float32)).to(cuda_device)
    x[: n // 100] = 40.0 + 0.3 * torch.rand(n // 100, 3, device=cuda_device)
    _, dens, color = _particles(shape, n, seed=11)
    bn = TB.bin_particles(x, shape, K)
    assert int(bn.n_overflow) > 0        # the crowd parks some
    bins = (TB.to_binned(bn, x), TB.to_binned(bn, dens.to(cuda_device)),
            TB.to_binned(bn, color.to(cuda_device)), bn.valid)
    g5 = torch.randn(shape + (5,), device=cuda_device)
    fwd, bwd = _check_kernels(bins, shape, K, g5)
    dirty, dead = _garbage(bins)
    fwd_d, bwd_d = _check_kernels(dirty, shape, K, g5)
    assert torch.equal(fwd_d, fwd)
    for got, want in zip(bwd_d, bwd):
        zero = got[..., dead]
        assert torch.equal(zero, torch.zeros_like(zero))
        assert not zero.signbit().any()
        assert torch.equal(got[..., ~dead], want[..., ~dead])
    batch = [torch.stack([t, t.flip(-1) if t.dtype == torch.bool else t])
             for t in bins]
    g2 = torch.stack([g5, -g5])
    fwd_b = BK.binsplat_color_fwd(*batch, K, shape)
    bwd_b = BK.binsplat_color_bwd(*batch, g2, K)
    for b in range(2):
        single = [t[b].contiguous() for t in batch]
        assert torch.equal(fwd_b[b], BK.binsplat_color_fwd(*single, K, shape))
        for got, want in zip(bwd_b, BK.binsplat_color_bwd(*single, g2[b], K)):
            assert torch.equal(got[b], want)


@pytest.mark.cuda
def test_colour_window_on_the_card_matches_the_cpu(cuda_device):
    """splat_binned_color_window's grids and gradients on the card
    against the same pass on the CPU (the twins)."""
    shape, K = (12, 9, 14), 4
    bins = _bins(shape, K, n=1500, seed=50)
    h = _cotangents(shape, seed=50)
    cpu = _pass(BK.splat_binned_color_window, bins, shape, K, h)
    gpu = _pass(BK.splat_binned_color_window,
                tuple(t.to(cuda_device) for t in bins), shape, K, h)
    _assert_close([t.cpu() for t in gpu], cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("bad,error", [
    ("positions on the cpu", ValueError), ("valid float", TypeError),
    ("dens half", TypeError), ("color short", ValueError),
    ("p 4d", ValueError), ("more slots than p", ValueError),
    ("g half", TypeError), ("g short", ValueError),
    ("color not contiguous", ValueError)])
def test_colour_operators_refuse_bad_inputs(cuda_device, bad, error):
    """The operators refuse a wrong device, type, shape, rank or layout of
    any of their tensors, and launch nothing."""
    shape, K = (4, 3, 5), 2
    bins = [t.to(cuda_device) for t in _bins(shape, K, n=60, seed=1,
                                             cluster=0)]
    g = torch.zeros(shape + (5,), device=cuda_device)
    if bad == "positions on the cpu":
        bins[0] = bins[0].cpu()
    elif bad == "valid float":
        bins[3] = bins[3].float()
    elif bad == "dens half":
        bins[1] = bins[1].half()
    elif bad == "color short":
        bins[2] = bins[2][:2].contiguous()
    elif bad == "p 4d":
        bins[0] = bins[0][None, None]
    elif bad == "more slots than p":
        bins = [t[..., :bins[3].shape[0] - 1].contiguous()
                for t in bins[:3]] + [bins[3]]
    elif bad == "g half":
        g = g.half()
    elif bad == "g short":
        g = g[:, :2].contiguous()
    else:
        bins[2] = bins[2].T.contiguous().T
    before = dict(BK.LAUNCHES)
    with pytest.raises(error):
        BK.binsplat_color_bwd(*bins, g, K)
    if not bad.startswith("g "):
        with pytest.raises(error):
            BK.binsplat_color_fwd(*bins, K, shape)
    assert BK.LAUNCHES == before


# (B, K, S, Z, Y, X) past what the entry points take: a batch past the
# grid's 65 535 blocks (along y, and along z where a keyframe takes 16
# blocks of K4c) or negative, slot arrays whose 3 S passes 32-bit offsets,
# a splat whose 5 Z Y X does, no rank, an empty grid, more dense slots
# than S
PAST = [(1 << 16, 1, 125, 1, 1, 1), (1 << 12, 1, 1625, 61, 1, 1),
        (-1, 1, 125, 1, 1, 1), (1, 1, 1 << 30, 1, 1, 1),
        (1, 1, 545_300_544, 1024, 1024, 512), (1, 0, 125, 1, 1, 1),
        (1, 1, 125, 0, 1, 1), (1, 2, 249, 1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["fwd", "bwd"])
@pytest.mark.parametrize("args", PAST)
def test_colour_entry_points_refuse_what_they_cannot_index(cuda_device,
                                                           entry, args):
    """The C entry points refuse, before they launch, a batch or a grid
    their 32-bit indices or the launch grid cannot reach (the pointers
    are never read)."""
    lib = ctypes.CDLL(str(BK.build_library()))
    p, i = ctypes.c_void_p, ctypes.c_int
    pointers = 5 if entry == "fwd" else 8
    fn = getattr(lib, f"nfs_binsplat_color_{entry}")
    fn.argtypes = [p] * pointers + [i] * 6 + [i, p]
    assert fn(*(None,) * pointers, *args, cuda_device.index, None) != 0


@pytest.mark.cuda
def test_a_colour_keyframe_on_the_card_launches_once_an_iteration(
        cuda_device, monkeypatch):
    """A 3D colour keyframe on the card: one K4c and one K5c launch per
    binned colour iteration, and the generic pass's body never runs."""
    def refuse(*args, **kwargs):
        raise AssertionError("the generic pass ran on the colour route")

    monkeypatch.setattr(TB, "_splat_binned", refuse)
    iters, octaves = 3, 2
    cfg = {"render.render_size": (32, 32), "render.min_render_size": 16,
           "render.n_views": 2, "render.view_pool": 4,
           "render.transmit": 0.5, "loss.style_layers": ("relu1_1",),
           "loss.style_layer_weights": (1.0,), "loss.w_style": 1000.0,
           "optim.octave_n": octaves, "optim.iters": iters,
           "particle.optimize_color": True,
           "particle.optimize_density": True, "particle.coarse_mode": "grid"}
    rng = np.random.default_rng(8)
    grid, n = (24, 16, 24), 2000
    x = (rng.random((n, 3)) * (np.asarray(grid) - 4.0) + 2.0)
    styler = TP.ParticleStyler(
        replace(StyleConfig(), **cfg), grid_shape=grid,
        style_image=rng.random((32, 32, 3), dtype=np.float32),
        device="cuda")
    before = dict(BK.LAUNCHES)
    styled, _, _ = styler.stylize_frame(ParticleSet(
        x=x.astype(np.float32), dens=np.ones(n, np.float32),
        color=rng.random((n, 3), dtype=np.float32)))
    launched = {k: BK.LAUNCHES[k] - before[k] for k in before}
    # the coarse octave runs in grid space, density only
    assert launched["color_fwd"] == launched["color_bwd"] == iters
    assert np.isfinite(styled.color.cpu().numpy()).all()
    assert math.isfinite(float(styled.x.abs().max()))
