"""nfs_tpu_torch's spatial sharding (``parallel/spatial.py``) against the
JAX package's on the CPU: the port's y-slabs on 4 gloo ranks
(``test_torch_parallel_ranks.py``, scenario ``spatial``) against JAX's
GSPMD sharding over ``spatial_mesh(4)`` of the conftest's virtual
devices, and against the port's own unsharded run.

The counterparts of ``tests/test_spatial.py``: placement, sharded against
unsharded, the state staying sharded through the octaves, the velocity
parameterization and the memory model; plus the mesh's rank layout, the
``shard_volume`` round trip (``tests/test_parallel.py``), the adjoint of
the advection halo, and a coarse octave too thin for the halo running
replicated.

Both packages load one VGG weights file and the same style image, with
``render.view_pool`` 1 (every draw is pool entry 0 in both), on the
Gaussian plume at style weight 1000 (ROADMAP F14). A density run without
advection is bitwise the port's unsharded run: the gather is exact, the
loss the same, the backward a slice. Runs with an advection halo are held
within the styler parity tolerance of ``tests/test_torch_styler.py``
(losses rtol 1e-5, d* and params within 1e-3), against JAX's sharded run
and against the port's unsharded one. Reference runs in this process use
one thread, as the ranks do, so that bitwise comparisons see the same
reduction order.
"""

import numpy as np
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params, save_vgg_params
from nfs_tpu.parallel import make_mesh as jax_make_mesh
from nfs_tpu.parallel import shard_volume as jax_shard_volume
from nfs_tpu.parallel.spatial import (
    persistent_state_bytes as jax_persistent_state_bytes)
from nfs_tpu.parallel.spatial import shard_volume_spatial as jax_shard
from nfs_tpu.parallel.spatial import spatial_mesh as jax_spatial_mesh
from nfs_tpu.parallel.spatial import stylize_frame_spatial as jax_stylize
from nfs_tpu.styler.grid import GridStyler as JaxGridStyler
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.ops import advect_kernels as ak
from nfs_tpu_torch.ops.advect import advect, advect_frames
from nfs_tpu_torch.parallel.mesh import Mesh
from nfs_tpu_torch.parallel.spatial import (
    SpaceSlabs, persistent_state_bytes, run_slabs, shard_volume_spatial)
from nfs_tpu_torch.styler.grid import GridStyler
from test_torch_parallel_ranks import run_ranks

torch.set_num_threads(2)

N = 4
SHAPE = (12, 16, 12)    # octaves (6, 8, 6) and SHAPE: slabs of 2 and 4
STYLE = np.random.default_rng(0).random((32, 32, 3), dtype=np.float32)
BASE = {
    "render.render_size": (32, 32),
    "render.n_views": 2,
    "render.view_pool": 1,
    "render.transmit": 0.05,
    "loss.style_layers": ("relu1_1",),
    "loss.style_layer_weights": (1.0,),
    "loss.w_style": 1000.0,
    "loss.w_tv": 0.1,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 3,
    "optim.lr": 0.02,
}
# name: (config overrides, with the W=1 window's velocities)
FRAMES = {
    "density": ({}, False),
    "velocity": ({"optim.parameterization": "velocity"}, False),
    # R = 3 rows: the coarse octave's 2-row slabs run replicated
    "window": ({"optim.window": 1}, True),
}
LOSS_RTOL, D_ATOL = 1e-5, 1e-3


def _blob(shape):
    g = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    return (1.5 * np.exp(-4 * sum(x ** 2 for x in g))).astype(np.float32)


def _vels():
    rng = np.random.default_rng(1)
    return (0.5 * rng.standard_normal((2,) + SHAPE + (3,))).astype(
        np.float32)


@pytest.fixture(scope="module")
def vgg_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
    save_vgg_params(path, init_vgg_params(0))
    return path


def _over(vgg_path, name):
    return dict(BASE, **{"loss.vgg_weights": vgg_path}, **FRAMES[name][0])


# name: (spatial dims, max_disp): K1-K3's plain twins, the 2D window-tap
# sum, the exact path
ADVECT = {"3d": (3, 2.0), "2d": (2, 2.0), "exact": (3, None)}


def _advect_case(name):
    ndim, max_disp = ADVECT[name]
    rng = np.random.default_rng(5 + ndim)
    shape = SHAPE if ndim == 3 else (16, 12)
    return {"kind": "advect", "n": N, "axis": 1 if ndim == 3 else 0,
            "max_disp": max_disp,
            "f": rng.random(shape, dtype=np.float32),
            "v": (1.5 * rng.standard_normal(shape + (ndim,))).astype(
                np.float32),
            "g": rng.standard_normal(shape).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(vgg_path, tmp_path_factory):
    """Every case on one 4-rank world: {name: (case, per-rank results)}."""
    cases = {f"mesh_{m}": {"kind": "mesh", "mesh": m}
             for m in ((2, 1, 2), (1, 2, 2))}
    cases["roundtrip"] = {"kind": "roundtrip", "d": np.arange(
        8 * 16, dtype=np.float32).reshape(8, 16)}
    for name in ADVECT:
        cases[f"advect_{name}"] = _advect_case(name)
    rng = np.random.default_rng(4)
    # w in quarters: its sums over the ranks are exact
    cases["gather"] = {"kind": "gather", "n": N,
                       "x": rng.random((4, 16, 4), dtype=np.float32),
                       "w": (rng.integers(-8, 8, (4, 16, 4)) / 4).astype(
                           np.float32)}
    for name, (_, window) in FRAMES.items():
        cases[name] = {"kind": "frame", "n": N, "d": _blob(SHAPE),
                       "v": _vels() if window else None,
                       "over": _over(vgg_path, name), "style": STYLE}
    out = run_ranks("spatial", {"cases": list(cases.values())}, N,
                    tmp_path_factory.mktemp("spatial"))
    return {name: (case, [r[i] for r in out])
            for i, (name, case) in enumerate(cases.items())}


_UNSHARDED = {}


def _port_unsharded(vgg_path, name):
    """The port's unsharded run, in one thread as the ranks run."""
    if name not in _UNSHARDED:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            styler = GridStyler(replace(StyleConfig(),
                                        **_over(vgg_path, name)),
                                style_image=STYLE, device="cpu")
            vels = _vels() if FRAMES[name][1] else None
            d, p, info = styler.stylize_frame(_blob(SHAPE), vels=vels)
        finally:
            torch.set_num_threads(threads)
        _UNSHARDED[name] = (d.numpy(), p.numpy(),
                            [l.numpy() for l in info["octave_losses"]])
    return _UNSHARDED[name]


def _jax_sharded(vgg_path, name):
    styler = JaxGridStyler(jax_replace(JaxStyleConfig(),
                                       **_over(vgg_path, name)),
                           style_image=STYLE)
    vels = _vels() if FRAMES[name][1] else None
    d, p, info = jax_stylize(styler, _blob(SHAPE), jax_spatial_mesh(N),
                             vels=vels)
    return (np.asarray(d), np.asarray(p),
            [np.asarray(l) for l in info["octave_losses"]])


def _same_on_every_rank(results):
    for r in results[1:]:
        for k in ("d", "params"):
            np.testing.assert_array_equal(r[k], results[0][k])


def _close(got, want):
    for a, b in zip(got["losses"], want[2]):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL)
    assert got["d"].shape == want[0].shape
    assert got["params"].shape == want[1].shape
    assert np.abs(got["d"] - want[0]).max() <= D_ATOL
    assert np.abs(got["params"] - want[1]).max() <= D_ATOL


# ------------------------------------------------------------------ #
# the mesh, placement, the memory model
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("mesh", [(2, 1, 2), (1, 2, 2)])
def test_mesh_places_ranks_as_jax(ranks, mesh):
    """Rank r sits where JAX's mesh puts device r, space innermost; each
    axis' ranks through it are JAX's device ids along that axis."""
    _, results = ranks[f"mesh_{mesh}"]
    jmesh = jax_make_mesh(*mesh)
    ids = np.vectorize(lambda dev: dev.id)(jmesh.devices)
    for r, res in enumerate(results):
        place = np.unravel_index(r, mesh)
        assert res["place"] == tuple(int(i) for i in place)
        assert res["shape"] == dict(jmesh.shape)
        for a, axis in enumerate(("frames", "views", "space")):
            line = list(place)
            line[a] = slice(None)
            assert res["ranks"][axis] == ids[tuple(line)].tolist()


def _fake_mesh(s, n=N):
    """Rank s's place on a (1, 1, n) mesh, without a process group (the
    slab arithmetic needs none)."""
    return Mesh(shape={"frames": 1, "views": 1, "space": n}, rank=s,
                world=n, distributed=False, frame_idx=0, view_idx=0,
                space_idx=s)


def test_placement_matches_jax_shards():
    d = np.random.default_rng(2).random((8, 16, 8), dtype=np.float32)
    jd = jax_shard(d, jax_spatial_mesh(N))
    slabs = [shard_volume_spatial(d, _fake_mesh(s)) for s in range(N)]
    assert len(jd.sharding.device_set) == N
    for s, slab in enumerate(slabs):
        assert tuple(slab.shape) == jd.addressable_shards[s].data.shape
        np.testing.assert_array_equal(
            slab.numpy(), np.asarray(jd.addressable_shards[s].data))
    # a y size that does not divide is refused by both
    with pytest.raises(ValueError):
        jax_shard(d[:, :10], jax_spatial_mesh(N))
    with pytest.raises(ValueError, match="cannot be split evenly"):
        shard_volume_spatial(d[:, :10], _fake_mesh(0))


@pytest.mark.parametrize("shape, param, taps", [
    ((832, 832, 832), "density", 5), ((112, 64, 112), "density", 5),
    ((112, 64, 112), "velocity", 5), ((256, 192), "velocity", 3)])
def test_memory_model_matches_jax(shape, param, taps):
    got = persistent_state_bytes(shape, param, taps)
    assert got == jax_persistent_state_bytes(shape, param, taps)
    if shape == (832, 832, 832):
        # exceeds one 16 GB chip unsharded, fits 8-way sharded
        assert got > 16e9 and got / 8 < 16e9


def test_shard_volume_roundtrip(ranks):
    case, results = ranks["roundtrip"]
    d = case["d"]
    jd = jax_shard_volume(d, jax_make_mesh(frames=1, views=8), axis=-1,
                          mesh_axis="views")
    np.testing.assert_array_equal(np.asarray(jd), d)
    np.testing.assert_array_equal(
        np.concatenate([r["part"] for r in results], axis=-1), d)
    for r in results:
        assert r["part"].shape == (8, 4) and r["owns"]
        np.testing.assert_array_equal(r["whole"], d * 2 + 1)


# ------------------------------------------------------------------ #
# the advection halo
# ------------------------------------------------------------------ #

def _slab_advect(f, v, g, md, n, grads, lead=0):
    """``SpaceSlabs.advect`` itself on each of the ``n`` y-slabs, forward
    and the gradients ``grads`` of the cotangent ``g``, the slabs run one
    after another in this process (``run_slabs``); the outputs assembled
    whole."""
    def one(ring):
        space = SpaceSlabs(None, f.shape[lead:], lead=lead, ring=ring)
        fs = space.slab(f).requires_grad_("field" in grads)
        vs = space.slab(v).requires_grad_("vel" in grads)
        y = space.advect(fs, vs, max_disp=md)
        need = [t for t in (fs, vs) if t.requires_grad]
        return (y.detach(),) + torch.autograd.grad(y, need, space.slab(g))

    return [torch.cat(parts, dim=lead + 1) for parts in
            zip(*run_slabs(one, n))]


# name: (max_disp, gradients taken, K3b for both, leading frame axes):
# K1 + K2, K1 + K3 at the velocity parameter's 1, K1 + K3b, and a batch
# of two frames through K1 + K2 + K3 as the engine advects
SLAB_CASES = {"field": (2.0, ("field",), False, 0),
              "vel": (1.0, ("vel",), False, 0),
              "fused": (2.0, ("field", "vel"), True, 0),
              "batched": (2.0, ("field", "vel"), False, 1)}


@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_slab_advect_in_one_process(monkeypatch, name):
    """The slab route at nonzero offsets on K1-K3b's plain twins, as
    chip_smoke.py drives the kernels: each slab padded by ``SlabHalo``
    with its neighbours' rows, its displacement rounded to the volume's
    coordinates, K1 and the velocity gradient bitwise the whole volume's;
    the field gradient, its halo rows' gradients returned to their
    owners, matches the whole volume's to f32 rounding (the sum order
    differs within R rows of a cut) and is bitwise elsewhere."""
    md, grads, fused, lead = SLAB_CASES[name]
    monkeypatch.setattr(ak, "FUSED_BWD", fused)
    rng = np.random.default_rng(3)
    shape = (2,) * lead + (8, 32, 8)    # slabs of 8 rows
    f = torch.from_numpy(rng.random(shape, dtype=np.float32))
    v = torch.from_numpy((1.5 * rng.standard_normal(shape + (3,))).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = _slab_advect(f, v, g, md, N, grads, lead)
    fw, vw = f.clone().requires_grad_("field" in grads), \
        v.clone().requires_grad_("vel" in grads)
    y = (advect_frames if lead else advect)(fw, vw, max_disp=md)
    want = [y.detach()] + list(torch.autograd.grad(
        y, [t for t in (fw, vw) if t.requires_grad], g))
    np.testing.assert_array_equal(got[0], want[0])
    if "vel" in grads:
        np.testing.assert_array_equal(got[-1], want[-1])
    if "field" in grads:
        gf, wf = got[1], want[1]
        np.testing.assert_allclose(gf, wf, rtol=0,
                                   atol=1e-6 * float(wf.abs().max()))
        # a source row takes gradient from outputs ceil(md) rows away
        h, r = shape[lead + 1] // N, int(np.ceil(md))
        far = [y for y in range(shape[lead + 1])
               if min(y % h, h - 1 - y % h) >= r]
        np.testing.assert_array_equal(gf[..., far, :], wf[..., far, :])


@pytest.mark.parametrize("name", sorted(ADVECT))
def test_halo_adjoint_matches_unsharded(ranks, name):
    """One slab ``advect`` on 4 ranks (K1-K3's plain twins in 3D, the
    window-tap sum in 2D): the output and the velocity gradient are
    bitwise the unsharded ones, the field gradient with the halo rows'
    gradients folded back onto their owners within f32 rounding; one
    halo exchange each way per rank and neighbour. The exact path
    (max_disp None) gathers the field instead and sums its gradient over
    the ranks."""
    case, results = ranks[f"advect_{name}"]
    f, v = (torch.from_numpy(case[k]).requires_grad_() for k in ("f", "v"))
    y = advect(f, v, max_disp=case["max_disp"])
    gf, gv = torch.autograd.grad((y * torch.from_numpy(case["g"])).sum(),
                                 (f, v))
    for s, r in enumerate(results):
        assert r["owns"]
        np.testing.assert_array_equal(r["y"], y.detach().numpy())
        np.testing.assert_array_equal(r["gv"], gv.numpy())
        np.testing.assert_allclose(r["gf"], gf.numpy(), rtol=0,
                                   atol=1e-6 * float(gf.abs().max()))
        neighbours = (s > 0) + (s < N - 1)
        c = r["collectives"]
        if case["max_disp"] is None:
            assert (c["send"], c["all_gather"], c["all_reduce"]) == (0, 1, 1)
        else:
            assert c["send"] == c["recv"] == 2 * neighbours
            assert c["all_gather"] == 0


def test_gather_backward_is_the_slice(ranks):
    """Every rank puts the gathered volume through the same loss, so the
    replicated gather's backward is the slice of the gradient to the
    rank's slab, not its sum over the ranks (which would scale it by 4,
    and hide behind Adam); the summed one (the exact advection's) is
    that sum. Both are slabs in storage of their own."""
    case, results = ranks["gather"]
    h = case["w"].shape[1] // N
    for s, r in enumerate(results):
        w = case["w"][:, s * h:(s + 1) * h]
        np.testing.assert_array_equal(r["grads"]["replicated"], w)
        np.testing.assert_array_equal(r["grads"]["summed"], N * w)
        assert r["owns"]
        c = r["collectives"]
        assert (c["all_gather"], c["all_reduce"]) == (2, 1)


# ------------------------------------------------------------------ #
# stylize_frame_spatial on 4 ranks
# ------------------------------------------------------------------ #

def test_density_sharded_is_bitwise_unsharded(ranks, vgg_path):
    """Density parameter, no advection: the sharded run on 4 ranks is
    the port's unsharded run, bit for bit, on every rank."""
    _, results = ranks["density"]
    _same_on_every_rank(results)
    d, p, losses = _port_unsharded(vgg_path, "density")
    np.testing.assert_array_equal(results[0]["d"], d)
    np.testing.assert_array_equal(results[0]["params"], p)
    for a, b in zip(results[0]["losses"], losses):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["velocity", "window"])
def test_sharded_matches_unsharded_port(ranks, vgg_path, name):
    _, results = ranks[name]
    _same_on_every_rank(results)
    _close(results[0], _port_unsharded(vgg_path, name))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_sharded_matches_jax_sharded(ranks, vgg_path, name):
    _, results = ranks[name]
    _close(results[0], _jax_sharded(vgg_path, name))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_state_stays_sharded_through_octaves(ranks, name):
    """The final full-resolution param, and with it the Adam state that
    made it, is a slab of H / 4 rows on every rank, in storage of its
    own, as are the density and the sim velocities the octave loop holds
    (a view would keep the whole volume allocated); the render gathered
    the volume (all_gathers) and only advection exchanged halos."""
    _, results = ranks[name]
    tail = (3,) if name == "velocity" else ()
    for r in results:
        assert r["slab_shape"] == (SHAPE[0], SHAPE[1] // N, SHAPE[2]) + tail
        assert r["owns"]
        c = r["collectives"]
        assert c["all_gather"] > 0 and c["all_reduce"] == 0
        assert (c["send"] > 0) == (name != "density")


def test_thin_octave_runs_replicated(ranks):
    """W = 1 at max_disp 2 needs R = 3 halo rows: the coarse octave's
    slabs (8 / 4 = 2 rows) are too thin, so it runs replicated and says
    so once per rank; the finest octave (4 rows) runs on slabs, and the
    result is the unsharded one (test_sharded_matches_unsharded_port)."""
    _, results = ranks["window"]
    for r in results:
        assert len(r["warnings"]) == 1
        assert "fewer than the 3-row advection halo" in r["warnings"][0]
        assert "replicated" in r["warnings"][0]
    assert all(not r["warnings"] for r in ranks["density"][1])
    space = SpaceSlabs(_fake_mesh(0), SHAPE, halo=3)
    with pytest.warns(UserWarning, match="divisible by the space mesh"):
        assert not space.sharded((12, 10, 12), warn=True)
    assert space.sharded(SHAPE) and not space.sharded((6, 8, 6))
