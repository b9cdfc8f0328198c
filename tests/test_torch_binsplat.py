"""nfs_tpu_torch splat ops against the JAX package on the CPU: binning,
the flat and binned splats, the binned window (the plain versions of the
CUDA kernels K4/K5 behind ``BinWindow``) and ``grid_sample``; and the
keyframe batches of binning, the binned splats and the window against
the single-keyframe calls, bit for bit.

Inputs are made with numpy from a seed and handed to both packages. The
JAX package's Pallas window runs as its own tests run it off a TPU
(interpret mode, ``splat_binned_pallas``).

Tolerances: binning is integer-valued and compared exactly. Values atol
1e-5 and gradients atol 1e-4: float32 sums of the same terms in another
order (measured <= 3.0e-7 in values and <= 7.2e-7 in gradients).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.ops import binsplat as JB
from nfs_tpu.ops.interp import grid_sample as jax_grid_sample
from nfs_tpu.ops.pallas_binsplat import splat_binned_pallas
from nfs_tpu_torch.ops import binsplat as TB
from nfs_tpu_torch.ops import binsplat_kernels as BK
from nfs_tpu_torch.ops.interp import grid_sample, identity_coords
from nfs_tpu_torch.ops.splat import gather, splat, splat_normalized

JS = importlib.import_module("nfs_tpu.ops.splat")

torch.set_num_threads(2)

VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4


def _crowded(n, shape, n_cluster, seed):
    """n spread particles plus n_cluster in a 0.05-cell cube at 5.0 (one
    base cell) and a margin outside the grid, so bins overflow and
    boundary taps get cropped."""
    rng = np.random.default_rng(seed)
    spread = np.array(shape) + 4
    x = np.concatenate([rng.random((n, len(shape))) * spread - 2.0,
                        5.0 + 0.05 * rng.random((n_cluster, len(shape)))])
    return x.astype(np.float32), rng


def _vjp_torch(fn, *args):
    """(output, grads of <output, h> wrt args) with a seeded cotangent."""
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*ts)
    h = torch.from_numpy(np.random.default_rng(99).random(
        tuple(out.shape), dtype=np.float32))
    grads = torch.autograd.grad((out * h).sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads], h.numpy()


def _vjp_jax(fn, h, *args):
    # one jit around value and vjp: XLA compiles the unrolled 27-tap
    # graphs several times faster that way than op by op
    @jax.jit
    def value_and_vjp(h, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(h)

    out, grads = value_and_vjp(jnp.asarray(h),
                               *(jnp.asarray(a) for a in args))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_matches(tfn, jfn, *args):
    """Values within VALUE_ATOL, gradients within GRAD_ATOL relative to
    the largest JAX gradient when that exceeds 1 (splat_normalized divides
    by weight sums near 0, where gradients reach 1e5)."""
    t_out, t_grads, h = _vjp_torch(tfn, *args)
    j_out, j_grads = _vjp_jax(jfn, h, *args)
    np.testing.assert_allclose(t_out, j_out, atol=VALUE_ATOL, rtol=0)
    for tg, jg in zip(t_grads, j_grads):
        scale = max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(tg, jg, atol=GRAD_ATOL * scale, rtol=0)


@pytest.mark.parametrize("kernel", ["bspline", "linear"])
@pytest.mark.parametrize("K", [2, 4])
def test_binning_matches_jax(kernel, K):
    """Stable ranks: the SAME particles park when a bin overflows."""
    shape = (10, 8, 12)
    x, _ = _crowded(800, shape, 300, seed=0)
    jb = JB.bin_particles(jnp.asarray(x), shape, K, kernel=kernel)
    tb = TB.bin_particles(torch.from_numpy(x), shape, K, kernel=kernel)
    assert int(tb.n_overflow) == int(jb.n_overflow) > 0
    np.testing.assert_array_equal(tb.slot.numpy(), np.asarray(jb.slot))
    np.testing.assert_array_equal(tb.valid.numpy(), np.asarray(jb.valid))
    np.testing.assert_array_equal(
        TB.bin_count_stats(torch.from_numpy(x), shape, kernel).numpy(),
        np.asarray(JB.bin_count_stats(jnp.asarray(x), shape, kernel)))
    assert int(TB.max_bin_count(torch.from_numpy(x), shape, kernel)) == \
        int(JB.max_bin_count(jnp.asarray(x), shape, kernel))
    # slot-minor round trip, parked particles included
    for arr in (x, x[:, 0].copy()):
        tb_arr = TB.to_binned(tb, torch.from_numpy(arr))
        np.testing.assert_array_equal(
            tb_arr.numpy(), np.asarray(JB.to_binned(jb, jnp.asarray(arr))))
        np.testing.assert_array_equal(TB.from_binned(tb, tb_arr).numpy(),
                                      arr)


def test_bucket_k_and_shapes():
    for k in range(0, 40):
        assert TB.bucket_k(k) == JB.bucket_k(k)
    assert TB.bucket_k(9000) == JB.bucket_k(9000) == 4096
    assert TB.padded_shape((5, 6, 7)) == JB.padded_shape((5, 6, 7))
    assert TB.PAD == JB.PAD
    with pytest.raises(ValueError):
        TB.n_taps("cubic")


def _flat_case(shape, grid, seed=1):
    """Positions around and past the grid; 'integer' rounds them to
    integers and half-integers, which puts the linear tent exactly at
    abs(0) and at its max(., 0) tie (ROADMAP queue 3, F1 and F6)."""
    x, rng = _crowded(300, shape, 0, seed=seed)
    if grid == "integer":
        x = np.round(x * 2) / 2
    return x, rng


@pytest.mark.parametrize("kernel", ["bspline", "linear"])
@pytest.mark.parametrize("grid", ["integer", "random"])
def test_flat_splat_matches_jax(kernel, grid):
    """Values and gradients wrt positions and attributes."""
    shape = (9, 7, 11)
    x, rng = _flat_case(shape, grid)
    attr = rng.random(len(x), dtype=np.float32)
    _assert_matches(lambda p, a: splat(p, a, shape, kernel=kernel),
                    lambda p, a: JS.splat(p, a, shape, kernel=kernel),
                    x, attr)


@pytest.mark.parametrize("kernel", ["bspline", "linear"])
def test_gather_matches_jax(kernel):
    shape = (9, 7, 11)
    x, rng = _flat_case(shape, "integer", seed=2)
    field = rng.random(shape + (2,), dtype=np.float32)
    _assert_matches(lambda f, p: gather(f, p, kernel=kernel),
                    lambda f, p: JS.gather(f, p, kernel=kernel), field, x)


@pytest.mark.parametrize("kernel", ["bspline", "linear"])
def test_flat_splat_2d_normalized_and_dilated_match_jax(kernel):
    """A 2D grid: the weight-normalized splat of 3 channels, and support
    1.2, the floor-based stencil with weights divided by the support."""
    shape = (12, 10)
    x, rng = _flat_case(shape, "integer", seed=3)
    _assert_matches(
        lambda p, a: splat_normalized(p, a, shape, kernel=kernel),
        lambda p, a: JS.splat_normalized(p, a, shape, kernel=kernel),
        x, rng.random((len(x), 3), dtype=np.float32))
    _assert_matches(
        lambda p, a: splat(p, a, shape, kernel=kernel, support=1.2),
        lambda p, a: JS.splat(p, a, shape, kernel=kernel, support=1.2),
        x, rng.random(len(x), dtype=np.float32))
    _assert_matches(
        lambda f, p: gather(f, p, kernel=kernel, support=1.2),
        lambda f, p: JS.gather(f, p, kernel=kernel, support=1.2),
        rng.random(shape, dtype=np.float32), x)


@pytest.mark.parametrize("kernel,shape,channels", [
    ("bspline", (10, 8, 12), 0),
    ("bspline", (10, 8, 12), 5),
    ("linear", (10, 8, 12), 0),
    ("bspline", (14, 12), 5),
])
def test_splat_binned_matches_jax(kernel, shape, channels):
    """The generic binned splat: 2D/3D, one or C = 5 channels, drifted
    positions and parked overflow."""
    x, rng = _crowded(900, shape, 200, seed=3)
    K = 3
    jb = JB.bin_particles(jnp.asarray(x), shape, K, kernel=kernel)
    tb = TB.bin_particles(torch.from_numpy(x), shape, K, kernel=kernel)
    assert int(tb.n_overflow) > 0
    x = x + (0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    attr = (rng.random((len(x), channels), dtype=np.float32) if channels
            else rng.random(len(x), dtype=np.float32))
    p_b = np.asarray(JB.to_binned(jb, jnp.asarray(x)))
    a_b = np.asarray(JB.to_binned(jb, jnp.asarray(attr)))
    _assert_matches(
        lambda p, a: TB.splat_binned(p, a, tb.valid, shape, K,
                                     kernel=kernel),
        lambda p, a: JB.splat_binned(p, a, jb.valid, shape, K,
                                     kernel=kernel),
        p_b, a_b)


def _window_case(case):
    """(positions at binning, positions after, attrs, K) of a window
    test case."""
    shape = (10, 8, 12)
    rng = np.random.default_rng(5)
    if case == "parked":
        x, rng = _crowded(700, shape, 200, seed=6)
        return shape, x, x, rng.random(len(x), dtype=np.float32), 2
    if case == "ties":   # integer and half-integer: the _dw1d ties
        x = (np.round(rng.random((600, 3)) * (np.array(shape) - 1) * 2)
             / 2.0).astype(np.float32)
        return shape, x, x, rng.random(600, dtype=np.float32), 8
    x, rng = _crowded(900, shape, 0, seed=7)
    attr = rng.random(len(x), dtype=np.float32)
    if case == "drift":
        moved = x + rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
        return shape, x, moved, attr, 4
    return shape, x, x, attr, 1          # "k1": most particles park


@pytest.mark.parametrize("case", ["drift", "parked", "ties", "k1"])
def test_window_matches_jax_pallas(case):
    """splat_binned_window (BinWindow over K4/K5's plain versions) against
    the JAX package's Pallas window: the value and the gradients wrt
    attributes and positions."""
    shape, x0, x, attr, K = _window_case(case)
    jb = JB.bin_particles(jnp.asarray(x0), shape, K)
    tb = TB.bin_particles(torch.from_numpy(x0), shape, K)
    if case in ("parked", "k1"):
        assert int(tb.n_overflow) > 0
    p_b = np.asarray(JB.to_binned(jb, jnp.asarray(x)))
    a_b = np.asarray(JB.to_binned(jb, jnp.asarray(attr)))
    before = dict(BK.LAUNCHES)
    _assert_matches(
        lambda p, a: BK.splat_binned_window(p, a, tb.valid, shape, K),
        lambda p, a: splat_binned_pallas(p, a, jb.valid, shape, K),
        p_b, a_b)
    assert BK.LAUNCHES == before  # CPU tensors: the plain versions ran


def test_window_plain_versions_match_generic():
    """window_fwd_plain / window_bwd_plain on raw bins against autograd
    of the generic splat_binned window on the padded grid; empty slots
    (a == 0) get exactly zero position gradient."""
    shape, x0, x, attr, K = _window_case("drift")
    tb = TB.bin_particles(torch.from_numpy(x0), shape, K)
    pshape = TB.padded_shape(shape)
    n_slots = tb.valid.shape[0]
    p_b = TB.to_binned(tb, torch.from_numpy(x))
    a4 = torch.where(tb.valid, TB.to_binned(tb, torch.from_numpy(attr)
                                            )[:n_slots], 0.0
                     ).view((K,) + pshape)
    p4 = [p_b[d, :n_slots].view((K,) + pshape).contiguous()
          for d in range(3)]
    g = torch.from_numpy(np.random.default_rng(8).random(
        pshape, dtype=np.float32))
    out = BK.window_fwd_plain(a4, *p4)
    da, dpz, dpy, dpx = BK.window_bwd_plain(a4, *p4, g)

    ts = [t.clone().requires_grad_(True) for t in [a4] + p4]
    # the generic splat over ALL padded cells: a grid PAD cells smaller
    # per side, padded back by splat_binned's own PAD ring
    ref = _generic_padded(ts, K, pshape)
    refs = torch.autograd.grad((ref * g).sum(), ts)
    torch.testing.assert_close(out, ref.detach(), atol=VALUE_ATOL, rtol=0)
    for got, want in zip((da, dpz, dpy, dpx), refs):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=0)
    empty = (a4 == 0)
    assert float(dpz[empty].abs().max()) == 0.0


def _slot_bins(frac_z, a, pshape=(6, 5, 7), K=2, seed=9):
    """(a4, [p_z, p_y, p_x], g) of K ranks on the padded grid ``pshape``
    where every slot has frac_z (p_z + PAD - b_z) and attribute ``a``
    broadcast over the slots, and frac 1.3 along y and x; g is seeded."""
    Z, Y, X = pshape
    shape = (K,) + pshape
    b = [torch.arange(n, dtype=torch.float32) for n in pshape]
    pz = (torch.as_tensor(frac_z, dtype=torch.float32) - TB.PAD
          + b[0].view(Z, 1, 1)).expand(shape).contiguous()
    py = (1.3 - TB.PAD + b[1].view(Y, 1)).expand(shape).contiguous()
    px = (1.3 - TB.PAD + b[2]).expand(shape).contiguous()
    a4 = torch.as_tensor(a, dtype=torch.float32).expand(shape).contiguous()
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        pshape).astype(np.float32))
    return a4, [pz, py, px], g


@pytest.mark.parametrize("frac_z", [-1.5, 3.5, -40.0, 1.0e4, float("inf"),
                                    float("nan")])
def test_window_bwd_dead_slot_contract(frac_z):
    """The contract K5's dead-slot route relies on, on its plain version:
    a slot whose frac lies outside (-1.5, 3.5) along an axis (here z;
    empty and parked slots may hold any position, NaN too) gets da == +0
    and dp_d == (+0) * a, so -0 where a < 0, for every a. Just inside the
    interval, and with a == 0, da is not 0: deadness is a matter of the
    positions, never of a."""
    a = torch.tensor([-1.5, -0.0, 0.0, 2.0]).view(4, 1, 1, 1, 1)
    for sign_a in a:
        a4, p4, g = _slot_bins(frac_z, sign_a)
        da, *dps = BK.window_bwd_plain(a4, *p4, g)
        assert bool((da == 0).all()) and not bool(da.signbit().any())
        for dp in dps:
            assert bool((dp == 0).all())
            assert torch.equal(dp.signbit(),
                               (torch.zeros(()) * a4).signbit())
    if math.isfinite(frac_z) and abs(frac_z) < 10:
        inside = frac_z + (0.01 if frac_z < 0 else -0.01)
        a4, p4, g = _slot_bins(inside, 0.0)
        da, *dps = BK.window_bwd_plain(a4, *p4, g)
        # at frac_z 3.49 only the tap oz = 2 reaches: the last two planes
        # of bins reach beyond the grid
        assert bool((da[:, :-2] != 0).all())
        assert all(bool((dp == 0).all()) for dp in dps)


def _generic_padded(ts, K, pshape):
    """out[q] over the padded grid by the generic formulation: sum over
    k and offsets of W * a, shifted by the offset."""
    a, pz, py, px = ts
    Z, Y, X = pshape
    fr = (pz + TB.PAD - torch.arange(Z, dtype=torch.float32).view(Z, 1, 1),
          py + TB.PAD - torch.arange(Y, dtype=torch.float32).view(Y, 1),
          px + TB.PAD - torch.arange(X, dtype=torch.float32))
    W = [[BK._w1d(float(o) - f) for o in range(3)] for f in fr]
    out = torch.zeros(pshape)
    for oz in range(3):
        for oy in range(3):
            for ox in range(3):
                c = (W[0][oz] * W[1][oy] * W[2][ox] * a).sum(0)
                out = out + torch.nn.functional.pad(
                    c, (ox, 0, oy, 0, oz, 0))[:Z, :Y, :X]
    return out


@pytest.mark.parametrize("bad,error,match", [
    ("nothing", None, None),
    ("a float64", TypeError, "float32"),
    ("p_y short", ValueError, "shape"),
    ("p_x not contiguous", ValueError, "contiguous"),
    ("a rank 3", ValueError, "Zp"),
    ("p_z on another device", ValueError, "expected"),
    ("all on the meta device", RuntimeError, "cpu or cuda"),
    ("g short", ValueError, "shape"),
    ("g float64", TypeError, "float32"),
    ("2D grid", ValueError, "3D grids"),
    ("a batch, g unbatched", ValueError, "shape"),
    ("a batch, p_z unbatched", ValueError, "shape"),
])
def test_window_wrappers_check_inputs(bad, error, match):
    """The one-pass check of K4's and K5's wrappers raises on a wrong
    type, shape, layout, rank or device of any bin array or of g, and on
    a device that is neither cpu nor cuda; on good CPU tensors both run
    their plain versions and count no launch."""
    a = torch.zeros((2, 6, 5, 7))
    p = [torch.zeros_like(a) for _ in range(3)]
    g = torch.zeros((6, 5, 7))
    if bad == "2D grid":
        with pytest.raises(error, match=match):
            BK.splat_binned_window(torch.zeros((2, 10)), torch.zeros((2, 10)),
                                   torch.ones(10, dtype=torch.bool), (4, 5), 1)
        return
    if bad == "a float64":
        a = a.double()
    elif bad == "p_y short":
        p[1] = p[1][:, :5].contiguous()
    elif bad == "p_x not contiguous":
        p[2] = p[2].transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "a rank 3":
        a = a[0]
    elif bad == "p_z on another device":
        p[0] = p[0].to("meta")
    elif bad == "all on the meta device":
        a, g = a.to("meta"), g.to("meta")
        p = [t.to("meta") for t in p]
    elif bad == "g short":
        g = g[:, :, :6].contiguous()
    elif bad == "g float64":
        g = g.double()
    elif bad.startswith("a batch"):
        a, p = a[None].contiguous(), [t[None].contiguous() for t in p]
        if bad == "a batch, p_z unbatched":
            p[0], g = p[0][0], g[None]
    before = dict(BK.LAUNCHES)
    if error is None:
        BK.binsplat_fwd(a, *p)
        BK.binsplat_bwd(a, *p, g)
    else:
        with pytest.raises(error, match=match):
            BK.binsplat_bwd(a, *p, g)
        if not bad.startswith("g ") and bad != "a batch, g unbatched":
            with pytest.raises(error, match=match):
                BK.binsplat_fwd(a, *p)
    assert BK.LAUNCHES == before


# ------------------------------------------------------------------ #
# keyframe batches: bit for bit the single-keyframe calls
# ------------------------------------------------------------------ #

def _keyframes(shape, B=3, seed=11):
    """B keyframes of one crowded cloud, each drifted differently (so
    their bins and parked particles differ), as one (B, N, dim) stack."""
    x, rng = _crowded(500, shape, 150, seed=seed)
    return np.stack([x + (0.4 * b * rng.standard_normal(x.shape)).astype(
        np.float32) for b in range(B)]), rng


def _binnings(xs, shape, K, kernel):
    batch = TB.bin_particles(torch.from_numpy(xs), shape, K, kernel=kernel)
    singles = [TB.bin_particles(torch.from_numpy(x), shape, K,
                                kernel=kernel) for x in xs]
    return batch, singles


@pytest.mark.parametrize("kernel,shape,K", [
    ("bspline", (10, 8, 12), 2), ("linear", (10, 8, 12), 3),
    ("bspline", (14, 12), 2)])
def test_batched_binning_equals_single_binnings(kernel, shape, K):
    """bin_particles of a (B, N, dim) stack: slot, valid and n_overflow
    rows equal B single binnings (F7's stable ranks per keyframe);
    bin_count_stats gives their rows; to_binned and from_binned of
    (B, N) and (B, N, C) equal the single calls, and round-trip."""
    xs, rng = _keyframes(shape)
    batch, singles = _binnings(xs, shape, K, kernel)
    assert all(int(s.n_overflow) > 0 for s in singles)
    for b, single in enumerate(singles):
        assert torch.equal(batch.slot[b], single.slot)
        assert torch.equal(batch.valid[b], single.valid)
        assert torch.equal(batch.n_overflow[b], single.n_overflow)
    assert torch.equal(
        TB.bin_count_stats(torch.from_numpy(xs), shape, kernel),
        torch.stack([TB.bin_count_stats(torch.from_numpy(x), shape, kernel)
                     for x in xs]))
    for arr in (xs, rng.random(xs.shape[:2], dtype=np.float32)):
        t = torch.from_numpy(arr)
        got = TB.to_binned(batch, t)
        want = torch.stack([TB.to_binned(s, a) for s, a in zip(singles, t)])
        assert torch.equal(got, want)
        assert torch.equal(TB.from_binned(batch, got), t)


@pytest.mark.parametrize("lead", [(), (2,)], ids=["single", "batch"])
def test_binning_of_no_particles(lead):
    """No particles bin to empty slots, and nothing parks."""
    shape, K = (4, 5, 6), 2
    bn = TB.bin_particles(torch.zeros(lead + (0, 3)), shape, K)
    n_slots = math.prod(TB.padded_shape(shape)) * K
    assert bn.slot.shape == lead + (0,)
    assert bn.valid.shape == lead + (n_slots,) and not bool(bn.valid.any())
    assert bn.n_overflow.shape == lead and not bool(bn.n_overflow.any())


def test_batched_binning_at_per_keyframe_capacities():
    """capacity gives each keyframe its own capacity within K ranks: a
    keyframe parks what a single binning at its capacity parks, keeps the
    same slots for the rest, and leaves the ranks past it empty."""
    shape, K = (10, 8, 12), 3
    xs, _ = _keyframes(shape, B=2, seed=14)
    caps = [2, 3]
    batch = TB.bin_particles(torch.from_numpy(xs), shape, K,
                             capacity=torch.tensor(caps))
    n_cells = math.prod(TB.padded_shape(shape))
    for b, cap in enumerate(caps):
        single = TB.bin_particles(torch.from_numpy(xs[b]), shape, cap)
        assert int(single.n_overflow) > 0
        assert torch.equal(batch.n_overflow[b], single.n_overflow)
        dense = single.slot < cap * n_cells
        assert torch.equal(batch.slot[b][dense], single.slot[dense])
        assert bool((batch.slot[b][~dense] >= K * n_cells).all())
        assert torch.equal(batch.valid[b][:cap * n_cells], single.valid)
        assert not bool(batch.valid[b][cap * n_cells:].any())


def _splat_grads(p_b, a_b, valid, shape, K, kernel, h):
    """splat_binned's value and its gradients wrt positions and
    attributes under the cotangent h."""
    p_b, a_b = (t.detach().requires_grad_(True) for t in (p_b, a_b))
    out = TB.splat_binned(p_b, a_b, valid, shape, K, kernel=kernel)
    return out, torch.autograd.grad((out * h).sum(), (p_b, a_b))


@pytest.mark.parametrize("kernel,shape,channels", [
    ("bspline", (10, 8, 12), 0), ("bspline", (10, 8, 12), 5),
    ("linear", (10, 8, 12), 0), ("bspline", (14, 12), 5)])
def test_batched_splat_binned_equals_single_splats(kernel, shape,
                                                   channels):
    """The generic splat_binned of a keyframe batch (drifted positions,
    parked overflow): its value and its gradients wrt positions and
    attributes equal B single splats bit for bit."""
    xs, rng = _keyframes(shape, seed=12)
    K = 2
    batch, singles = _binnings(xs, shape, K, kernel)
    moved = torch.from_numpy(xs + (0.3 * rng.standard_normal(xs.shape))
                             .astype(np.float32))
    tail = (channels,) if channels else ()
    attr = torch.from_numpy(rng.random(xs.shape[:2] + tail,
                                       dtype=np.float32))
    h = torch.from_numpy(rng.random((len(xs),) + shape + tail,
                                    dtype=np.float32))
    got, got_g = _splat_grads(TB.to_binned(batch, moved),
                              TB.to_binned(batch, attr), batch.valid, shape,
                              K, kernel, h)
    for b, single in enumerate(singles):
        out, grads = _splat_grads(TB.to_binned(single, moved[b]),
                                  TB.to_binned(single, attr[b]),
                                  single.valid, shape, K, kernel, h[b])
        assert torch.equal(got[b], out)
        for g, w in zip(got_g, grads):
            assert torch.equal(g[b], w)


def test_batched_window_equals_single_windows():
    """K4's and K5's plain twins on (B, K, Zp, Yp, Xp) bins equal B single
    calls bit for bit and count no launch on the CPU; splat_binned_window
    of a keyframe batch (value and gradients) equals the single
    windows."""
    shape, K = (10, 8, 12), 2
    xs, rng = _keyframes(shape, seed=13)
    batch, singles = _binnings(xs, shape, K, "bspline")
    moved = torch.from_numpy(xs + rng.uniform(-0.5, 0.5, xs.shape).astype(
        np.float32))
    attr = torch.from_numpy(rng.random(xs.shape[:2], dtype=np.float32))
    pshape = TB.padded_shape(shape)
    n_slots = math.prod(pshape) * K
    g = torch.from_numpy(rng.standard_normal((len(xs),) + pshape,
                                             dtype=np.float32))

    def bins(bn, p, a):
        p_b, a_b = TB.to_binned(bn, p), TB.to_binned(bn, a)
        lead = tuple(a_b.shape[:-1])
        a4 = torch.where(bn.valid, a_b[..., :n_slots], 0.0).reshape(
            lead + (K,) + pshape)
        return a4, [p_b[..., d, :n_slots].reshape(lead + (K,) + pshape)
                    .contiguous() for d in range(3)]

    before = dict(BK.LAUNCHES)
    a5, p5 = bins(batch, moved, attr)
    fwd = BK.binsplat_fwd(a5, *p5)
    bwd = BK.binsplat_bwd(a5, *p5, g)
    assert fwd.shape == (len(xs),) + pshape
    for b, single in enumerate(singles):
        a4, p4 = bins(single, moved[b], attr[b])
        assert torch.equal(fwd[b], BK.binsplat_fwd(a4, *p4))
        for got, want in zip(bwd, BK.binsplat_bwd(a4, *p4, g[b])):
            assert torch.equal(got[b], want)
    assert BK.LAUNCHES == before

    h = torch.from_numpy(rng.random((len(xs),) + shape, dtype=np.float32))

    def window(bn, p, a, hh):
        p_b = TB.to_binned(bn, p).requires_grad_(True)
        a_b = TB.to_binned(bn, a).requires_grad_(True)
        out = BK.splat_binned_window(p_b, a_b, bn.valid, shape, K)
        return out, torch.autograd.grad((out * hh).sum(), (p_b, a_b))

    out, grads = window(batch, moved, attr, h)
    for b, single in enumerate(singles):
        o, gs = window(single, moved[b], attr[b], h[b])
        assert torch.equal(out[b], o)
        for gb, gw in zip(grads, gs):
            assert torch.equal(gb[b], gw)


@pytest.mark.parametrize("mode", ["clamp", "zero"])
@pytest.mark.parametrize("channels", [0, 2])
def test_grid_sample_matches_jax(mode, channels):
    """Values and both gradients of the custom VJP; coordinates reach past
    the grid on every side and include integer ones."""
    shape = (6, 5, 7)
    rng = np.random.default_rng(11)
    field = rng.random(shape + ((channels,) if channels else ()),
                       dtype=np.float32)
    coords = (rng.random((40, 3)) * (np.array(shape) + 2) - 1.0
              ).astype(np.float32)
    coords[:8] = np.round(coords[:8])
    _assert_matches(lambda f, c: grid_sample(f, c, mode=mode),
                    lambda f, c: jax_grid_sample(f, c, mode=mode),
                    field, coords)


def test_identity_coords_and_bad_mode():
    from nfs_tpu.ops.interp import identity_coords as jax_identity

    np.testing.assert_array_equal(identity_coords((3, 4, 2)).numpy(),
                                  np.asarray(jax_identity((3, 4, 2))))
    with pytest.raises(ValueError, match="boundary mode"):
        grid_sample(torch.zeros((3, 3)), torch.zeros((2, 2)), mode="wrap")


def test_binsplat_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Both libraries come from one build helper, keyed on each source's
    own hash; without nvcc the binned-splat library cannot build."""
    import shutil

    from nfs_tpu_torch.ops import _cuda_build
    from nfs_tpu_torch.ops import advect_kernels as ak

    assert BK.SOURCE.name == "binsplat.cu"
    paths = {_cuda_build.library_path(BK.SOURCE, "nfs_binsplat"),
             ak.library_path()}
    assert len(paths) == 2
    assert all(p.parent == _cuda_build.BUILD_DIR for p in paths)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    BK.load_library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        BK.load_library()
    BK.load_library.cache_clear()
