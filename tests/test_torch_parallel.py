"""nfs_tpu_torch's multi-device layer against the JAX package's on the CPU:
the mesh, ``halo_exchange`` (4 gloo ranks against JAX's under
``shard_map`` on the conftest's virtual devices, exact), the sharded
window step with the JAX tests' toy loss (gloo meshes against JAX on the
same mesh shapes and against the port's own (1, 1) step), the launcher
(a torchrun environment, or an explicit rendezvous),
and the frame batch of the advection operators (the plain twins against
per-frame calls, bitwise; ``AdvectWindow`` and ``advect_frames``
gradients under a batch).

The ranks run ``test_torch_parallel_ranks.py`` in fresh processes, which
import the port only.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from nfs_tpu.ops.advect import advect as jax_advect
from nfs_tpu.parallel import halo_exchange as jax_halo_exchange
from nfs_tpu.parallel import make_mesh as jax_make_mesh
from nfs_tpu.parallel import make_sharded_window_step as jax_make_step
from nfs_tpu.parallel.mesh import mesh_shape_for as jax_mesh_shape_for
from nfs_tpu_torch.ops import advect_kernels as ak
from nfs_tpu_torch.ops.advect import advect, advect_frames
from nfs_tpu_torch.parallel import (
    halo_exchange, initialize_multihost, make_mesh, make_sharded_window_step)
from nfs_tpu_torch.parallel.mesh import mesh_shape_for
from nfs_tpu_torch.styler.octave import Adam
from test_torch_parallel_ranks import run_ranks, toy_loss_frames

torch.set_num_threads(2)


# ------------------------------------------------------------------ #
# mesh and launcher
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_for_matches_jax(n):
    assert mesh_shape_for(n) == jax_mesh_shape_for(n)


def test_single_process_mesh():
    mesh = make_mesh(1, 1)
    assert mesh.shape == dict(jax_make_mesh(1, 1).shape)
    assert (mesh.rank, mesh.world, mesh.frame_idx, mesh.view_idx) == (
        0, 1, 0, 0)
    assert not mesh.distributed and mesh.frames_group is None


def test_too_big_raises_with_jax_numbers():
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(frames=16, views=2)
    with pytest.raises(ValueError) as err:
        make_mesh(frames=16, views=2)
    want = str(jax_err.value).rsplit(" exceeds", 1)[0]
    assert str(err.value).startswith(want)
    assert str(err.value).endswith("exceeds 1 available devices")


def test_initialize_multihost(monkeypatch):
    """A single process needs no group; a launch that says it has ranks
    but not which one this is raises instead of running alone."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost("cpu") == 1
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_multihost("cpu") == 1
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(KeyError):
        initialize_multihost("cpu")
    assert not torch.distributed.is_initialized()


_RENDEZVOUS = """
import sys
import torch
import torch.distributed as dist
from nfs_tpu_torch.parallel import initialize_multihost
rank = int(sys.argv[2])
world = initialize_multihost("cpu", coordinator=sys.argv[1],
                             num_processes=2, process_id=rank)
x = torch.tensor([rank + 1.0])
dist.all_reduce(x)
print(world, dist.get_rank(), dist.get_world_size(), int(x))
dist.destroy_process_group()
"""


def test_initialize_multihost_explicit_rendezvous(tmp_path):
    """coordinator "host:port", num_processes and process_id, as the JAX
    function takes them: two gloo processes meet at a free localhost port
    with no launcher variables set, and reduce across the pair."""
    import socket
    import subprocess
    import sys

    from test_torch_parallel_ranks import ROOT

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RENDEZVOUS, f"localhost:{port}", str(r)],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert out.split()[-4:] == ["2", str(r), "2", "3"], out


@pytest.mark.parametrize("given", [
    {"coordinator": "localhost:1"},
    {"coordinator": "localhost:1", "num_processes": 2},
    {"num_processes": 2, "process_id": 0},
    {"process_id": 1},
])
def test_initialize_multihost_partial_arguments_raise(given):
    """A partial rendezvous is refused before any process group forms: a
    misconfigured launch never runs as a single process."""
    with pytest.raises(ValueError, match="go together"):
        initialize_multihost("cpu", **given)
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------------ #
# halo exchange: 4 gloo ranks against JAX under shard_map
# ------------------------------------------------------------------ #

HALO_CASES = [(12, 1, True), (12, 2, True), (8, 3, True),
              (12, 1, False), (8, 3, False)]


@pytest.fixture(scope="module")
def halo_ranks(tmp_path_factory):
    return run_ranks("halo", {"cases": HALO_CASES}, 4,
                     tmp_path_factory.mktemp("halo"))


def _jax_halo(T, halo, clamp):
    mesh = jax_make_mesh(frames=4, views=1)
    x = jnp.arange(2 * T, dtype=jnp.float32).reshape(T, 2)

    def body(xl):
        left, right = jax_halo_exchange(xl, halo, "frames",
                                        clamp_edges=clamp)
        return jnp.concatenate([left, xl, right], axis=0)

    out = shard_map(body, mesh=mesh, in_specs=P("frames"),
                    out_specs=P("frames"), check_vma=False)(x)
    return np.asarray(out).reshape(4, -1, 2)


@pytest.mark.parametrize("case", HALO_CASES)
def test_halo_exchange_matches_jax(halo_ranks, case):
    T, halo, clamp = case
    want = _jax_halo(*case)
    for rank, res in enumerate(halo_ranks):
        got, counts = res[case]
        np.testing.assert_array_equal(got, want[rank])
        if halo > T // 4:       # deeper than the shard: one all_gather
            assert counts == {"send": 0, "recv": 0, "all_gather": 1}
        elif clamp and rank in (0, 3):
            # the clamp replaces the edge ranks' outer halo: nothing sent
            assert counts == {"send": 1, "recv": 1, "all_gather": 0}
        else:
            assert counts == {"send": 2, "recv": 2, "all_gather": 0}


def test_halo_exchange_single_shard_is_local():
    x = torch.arange(8.0).reshape(4, 2)
    counts = {"send": 0, "recv": 0, "all_gather": 0}
    left, right = halo_exchange(x, 2, make_mesh(1, 1), counts=counts)
    np.testing.assert_array_equal(left.numpy(), [[0, 1], [0, 1]])
    np.testing.assert_array_equal(right.numpy(), [[6, 7], [6, 7]])
    assert counts == {"send": 0, "recv": 0, "all_gather": 0}


# ------------------------------------------------------------------ #
# sharded window step: the JAX tests' toy problem
# ------------------------------------------------------------------ #

T, H, W, NV, ITERS = 8, 16, 12, 4, 3


def _toy_inputs():
    rng = np.random.default_rng
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(T, dtype=jnp.uint32))
    # the JAX step's on-device view draws, for the port's step
    view_idx = np.array([[int(jax.random.randint(jax.random.fold_in(
        jax.random.fold_in(keys[t], it), 1), (), 0, 5))
        for it in range(ITERS)] for t in range(T)])
    return {
        "d": rng(0).random((T, H, W)).astype(np.float32),
        "vels": (0.3 * rng(1).standard_normal((T, H, W, 2))).astype(
            np.float32),
        "params": np.zeros((T, H, W), np.float32),
        "pool": rng(2).random((5, NV, 2)).astype(np.float32),
        "target": rng(3).random((H, W)).astype(np.float32),
        "view_idx": view_idx,
    }, keys


def _jax_toy_loss(param, d_i, vels_w, views_i, key_i, aux):
    d_star = d_i + param
    base = jnp.mean((d_star - aux["target"]) ** 2)
    if vels_w is not None:
        d_f = jax_advect(d_star, vels_w[vels_w.shape[0] // 2])
        base = base + jnp.mean((d_f - aux["target"]) ** 2)
    return jnp.sum(base * (1.0 + 0.1 * views_i[:, 0])) / NV


def _jax_step(fv, window):
    inp, keys = _toy_inputs()
    opt = optax.adam(0.05)
    params = jnp.asarray(inp["params"])
    step = jax_make_step(jax_make_mesh(*fv), _jax_toy_loss, opt,
                         window=window, n_views=NV,
                         opt_state_example=opt.init(params), n_iters=ITERS)
    p, _, losses = step(params, opt.init(params), jnp.asarray(inp["d"]),
                        jnp.asarray(inp["vels"]), jnp.asarray(inp["pool"]),
                        keys, {"target": jnp.asarray(inp["target"])},
                        jnp.int32(0))
    return np.asarray(p), np.asarray(losses)


def _port_step_single(window):
    """The port's step on a (1, 1) mesh in this process."""
    inp = {k: torch.from_numpy(v) for k, v in _toy_inputs()[0].items()}
    opt = Adam(0.05)
    step = make_sharded_window_step(
        make_mesh(1, 1), toy_loss_frames(NV, inp["target"]), opt,
        window=window, n_views=NV, n_iters=ITERS)
    p, _, losses = step(inp["params"], opt.init(inp["params"]), inp["d"],
                        inp["vels"], inp["pool"], inp["view_idx"], None, 0)
    assert step.collectives == dict.fromkeys(step.collectives, 0)
    return p.numpy(), losses.numpy()


STEP_CASES = [(2, 2, 1, ITERS), (4, 1, 1, ITERS), (1, 2, 1, ITERS),
              (4, 1, 3, ITERS)]


@pytest.fixture(scope="module")
def step_ranks(tmp_path_factory):
    return run_ranks("step", {"inputs": _toy_inputs()[0], "cases":
                              STEP_CASES, "n_views": NV}, 4,
                     tmp_path_factory.mktemp("step"))


def _assemble(step_ranks, case):
    """The global params of a case from the ranks of view shard 0, and
    every shard rank's losses."""
    shards = [r[case] for r in step_ranks if case in r]
    frames = case[0]
    parts = sorted((s["frame_idx"], s["params"]) for s in shards
                   if s["view_idx"] == 0)
    assert [f for f, _ in parts] == list(range(frames))
    return np.concatenate([p for _, p in parts]), shards


@pytest.mark.parametrize("case", STEP_CASES)
def test_sharded_step_matches_jax_and_single(step_ranks, case):
    """The (2, 2), (4, 1) and (1, 2) gloo meshes (and a window of 3 on
    shards of 2 frames: the all_gather halo) against JAX's step on the
    same mesh and against the port's (1, 1) step. A missing views
    all_reduce would leave each views rank with its partial gradient."""
    frames, views, window, _ = case
    params, shards = _assemble(step_ranks, case)
    jp, jl = _jax_step((frames, views), window)
    sp, sl = _port_step_single(window)
    # f32 sums of the same terms in other orders, through 3 Adam steps
    np.testing.assert_allclose(params, jp, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(params, sp, rtol=1e-5, atol=1e-6)
    for s in shards:
        np.testing.assert_allclose(s["losses"], jl, rtol=1e-5)
        np.testing.assert_allclose(s["losses"], sl, rtol=1e-5)
        c = s["collectives"]
        # one views all_reduce per iteration, one frames sum per call
        assert c["all_reduce"] == ITERS + 1
        deep = window > T // frames
        assert c["all_gather"] == int(deep and frames > 1)


def test_sharded_step_window_zero_and_bad_views():
    inp = {k: torch.from_numpy(v) for k, v in _toy_inputs()[0].items()}
    opt = Adam(0.05)
    step = make_sharded_window_step(
        make_mesh(1, 1), toy_loss_frames(NV, inp["target"]), opt, window=0,
        n_views=NV, n_iters=2)
    p, _, losses = step(inp["params"], opt.init(inp["params"]), inp["d"],
                        None, inp["pool"], inp["view_idx"], None, 1)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert float(p.abs().max()) > 0.0
    mesh = dataclasses.replace(make_mesh(1, 1),
                               shape={"frames": 1, "views": 3})
    with pytest.raises(ValueError, match="must divide the views mesh"):
        make_sharded_window_step(mesh, None, opt, window=0, n_views=NV)


# ------------------------------------------------------------------ #
# the frame batch of the advection operators
# ------------------------------------------------------------------ #

def _batch(seed, B=3, shape=(6, 5, 7), md=2.0):
    rng = np.random.default_rng(seed)
    f = rng.random((B,) + shape, dtype=np.float32)
    g = rng.standard_normal((B,) + shape, dtype=np.float32)
    v = (md / 1.2816) * rng.standard_normal((B,) + shape + (3,),
                                            dtype=np.float32)
    return tuple(torch.from_numpy(a) for a in (f, g, v))


PLAIN = {
    "fwd": (lambda f, g, v, d: ak.advect_fwd(f, v, d),
            lambda f, g, v, d: ak.advect_fwd_plain(f, v, d)),
    "bwd_field": (lambda f, g, v, d: ak.advect_bwd_field(v, g, d),
                  lambda f, g, v, d: ak.advect_bwd_field_plain(v, g, d)),
    "bwd_vel": (lambda f, g, v, d: ak.advect_bwd_vel(f, v, g, d),
                lambda f, g, v, d: ak.advect_bwd_vel_plain(f, v, g, d)),
    "bwd_fused": (lambda f, g, v, d: ak.advect_bwd_fused(f, v, g, d),
                  lambda f, g, v, d: ak.advect_bwd_fused_plain(f, v, g, d)),
}


def _stack(outs):
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("key", sorted(PLAIN))
@pytest.mark.parametrize("md", [1.0, 9.0])
def test_batched_wrappers_equal_per_frame_calls(key, md):
    """Every advection wrapper and plain twin takes (B, D, H, W) and gives
    the bits of B single calls (max_disp 9 takes K2's binned route on the
    card)."""
    f, g, v = _batch(0, md=md)
    wrapper, plain = PLAIN[key]
    per_frame = _stack([plain(f[b], g[b], v[b], md) for b in range(3)])
    before = dict(ak.LAUNCHES)
    assert _equal(plain(f, g, v, md), per_frame)
    assert _equal(wrapper(f, g, v, md), per_frame)
    assert ak.LAUNCHES == before    # CPU tensors: plain twins, no launch


def test_batched_wrappers_check_shapes():
    f, g, v = _batch(1)
    with pytest.raises(ValueError, match="shape"):
        ak.advect_fwd(f, v[:2].contiguous(), 2.0)
    with pytest.raises(ValueError, match=r"\(B, D, H, W\)"):
        ak.advect_bwd_field(v[None], g[None], 2.0)


@pytest.mark.parametrize("need", ["field", "vel", "both"])
def test_advect_window_gradients_under_a_batch(need):
    """AdvectWindow on a (B, D, H, W) batch: the value and both gradients
    are the per-frame ones, bitwise."""
    f, g, v = _batch(2)
    fb, vb = (f.clone().requires_grad_(need != "vel"),
              v.clone().requires_grad_(need != "field"))
    out = ak.AdvectWindow.apply(fb, vb, 2.0)
    out.backward(g)
    fs, vs = (f.clone().requires_grad_(need != "vel"),
              v.clone().requires_grad_(need != "field"))
    ref = torch.stack([ak.AdvectWindow.apply(fs[b], vs[b], 2.0)
                       for b in range(3)])
    ref.backward(g)
    assert torch.equal(out, ref)
    for a, b in ((fb, fs), (vb, vs)):
        assert (a.grad is None) == (b.grad is None)
        if a.grad is not None:
            assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("kind", ["3d", "3d_channels", "2d", "exact",
                                  "xla"])
def test_advect_frames_equals_per_frame_advect(kind):
    """advect_frames over a batch: the K1-K3 route for 3D clamp-mode
    fields (per channel for a channelled field), per-frame advect for 2D,
    the exact path and impl='xla'; values and gradients."""
    rng = np.random.default_rng(3)
    shape = (6, 5, 7) if kind != "2d" else (9, 8)
    tail = (2,) if kind == "3d_channels" else ()
    f = torch.from_numpy(rng.random((2,) + shape + tail, dtype=np.float32))
    v = torch.from_numpy((1.3 * rng.standard_normal(
        (2,) + shape + (len(shape),))).astype(np.float32))
    kw = {"max_disp": None if kind == "exact" else 2.0,
          "impl": "xla" if kind == "xla" else "auto", "dt": -1.0}
    fa, va = f.clone().requires_grad_(), v.clone().requires_grad_()
    out = advect_frames(fa, va, **kw)
    fb, vb = f.clone().requires_grad_(), v.clone().requires_grad_()
    ref = torch.stack([advect(fb[b], vb[b], **kw) for b in range(2)])
    assert torch.equal(out, ref)
    cot = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32))
    out.backward(cot)
    ref.backward(cot)
    assert torch.equal(fa.grad, fb.grad) and torch.equal(va.grad, vb.grad)
