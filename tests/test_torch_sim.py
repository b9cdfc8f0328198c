"""nfs_tpu_torch data generation against the JAX package on the CPU: the
smoke solver (2D and 3D) and the FLIP solver step for step, resumable
chunked generation, and the chunk directory, ``.uni`` files and sequence
manifest that both packages must read the same.

Both sides start from the same state: the solvers' zero fields, and the
FLIP particles that both seed with numpy. JAX's 3D advection is its XLA
window sum on the CPU, the port's the K1 plain version.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.io import stream as jax_stream
from nfs_tpu.io.checkpoint import SequenceManifest as JaxManifest
from nfs_tpu.io.uni import read_uni as jax_read_uni
from nfs_tpu.io.uni import write_uni as jax_write_uni
from nfs_tpu.sim import flip as jax_flip
from nfs_tpu.sim import smoke as jax_smoke
from nfs_tpu_torch.io import stream
from nfs_tpu_torch.io.checkpoint import SequenceManifest
from nfs_tpu_torch.io.uni import read_uni, write_uni
from nfs_tpu_torch.ops import advect_kernels as ak
from nfs_tpu_torch.sim import flip, smoke

torch.set_num_threads(2)

SMOKE_CASES = {"3d": ((16, 12, 16), (0.5, 0.85, 0.5)),
               "2d": ((24, 16), (0.85, 0.5))}


@pytest.mark.parametrize("case", sorted(SMOKE_CASES))
def test_smoke_steps_match_jax(case):
    shape, center = SMOKE_CASES[case]
    kw = dict(shape=shape, source_center=center, jacobi_iters=10)
    js = jax_smoke.SmokeSolver(jax_smoke.SmokeConfig(**kw))
    ts = smoke.SmokeSolver(smoke.SmokeConfig(**kw), device="cpu")
    jd = jnp.zeros(shape, jnp.float32)
    jv = jnp.zeros(shape + (len(shape),), jnp.float32)
    td, tv = ts.initial_state()
    for _ in range(3):
        jd, jv = js.step(jd, jv)
        td, tv = ts.step(td, tv)
        # f32 sums in another order (window sum against K1's 8 corners,
        # XLA against torch): measured <= 2.2e-7 of the field's max
        for got, want in ((td, jd), (tv, jv)):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, atol=1e-5 * float(np.abs(want).max()))
    assert td.min() >= 0.0 and float(td.sum()) > 0.0


def test_smoke_step_launches_seven_k1_per_3d_step(monkeypatch):
    """A 3D step advects the density once and the three velocity
    channels forward and back (MacCormack): seven K1 calls."""
    calls = []
    orig = ak.advect_fwd
    monkeypatch.setattr(ak, "advect_fwd",
                        lambda *a: calls.append(1) or orig(*a))
    ts = smoke.SmokeSolver(smoke.SmokeConfig(
        shape=(8, 6, 8), source_center=(0.5, 0.85, 0.5), jacobi_iters=2),
        device="cpu")
    d, v = ts.step(*ts.initial_state())
    ts.step(d, v)
    assert len(calls) == 14


@pytest.mark.parametrize("shape", [(32, 32), (12, 12, 12)])
def test_flip_steps_match_jax(shape):
    nd = len(shape)
    kw = dict(shape=shape, jacobi_iters=10,
              block_lo=(0.05,) + (0.3,) * (nd - 1),
              block_hi=(0.5,) + (0.7,) * (nd - 1))
    jp = jax_flip.seed_particles(jax_flip.FlipConfig(**kw), seed=3)
    tp = flip.seed_particles(flip.FlipConfig(**kw), seed=3, device="cpu")
    np.testing.assert_array_equal(tp.x.numpy(), np.asarray(jp.x))
    jsol = jax_flip.FlipSolver(jax_flip.FlipConfig(**kw))
    tsol = flip.FlipSolver(flip.FlipConfig(**kw))
    jx, jvel, tx, tvel = jp.x, jp.vel, tp.x, tp.vel
    for _ in range(3):
        jx, jvel = jsol.step(jx, jvel)
        tx, tvel = tsol.step(tx, tvel)
    # positions in cells: measured <= 9.6e-7 apart after 3 steps
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4)
    np.testing.assert_allclose(tvel.numpy(), np.asarray(jvel), atol=1e-4)


def test_liquid_sequence_shapes():
    cfg = flip.FlipConfig(shape=(16, 16), jacobi_iters=4)
    xs, vels = flip.liquid_sequence(cfg, 3, device="cpu")
    n = flip.seed_particles(cfg, device="cpu").n
    assert xs.shape == vels.shape == (3, n, 2)
    assert np.isfinite(xs).all()
    assert xs.min() >= 1.0 and xs.max() <= 15.0


CACHE_CFG = dict(shape=(12, 10, 12), source_center=(0.5, 0.85, 0.5),
                 jacobi_iters=6, max_disp=2.0)


@pytest.mark.parametrize("target", ["seq", "seq.npz"])
def test_budgeted_cache_resume_bit_matches_one_shot(tmp_path, target):
    """As tests/test_sim.py: with budget 0 each call finishes one chunk;
    chained calls reproduce the one-shot sequence bit for bit."""
    cfg = smoke.SmokeConfig(**CACHE_CFG)
    ref_d, ref_v = smoke.smoke_sequence(cfg, 10, warmup=4, chunk=4,
                                        device="cpu")
    path = str(tmp_path / target)
    n = 1
    while not smoke.smoke_sequence_cached(cfg, 10, path, warmup=4, chunk=4,
                                          budget_s=0, device="cpu"):
        n += 1
        assert n < 10, "resume loop did not terminate"
    assert n > 1, "budget 0 should need several calls"
    got_d, got_v = stream.load_sequence_cache(path)
    np.testing.assert_array_equal(got_d, ref_d)
    np.testing.assert_array_equal(got_v, ref_v)
    assert smoke.smoke_sequence_cached(cfg, 10, path, warmup=4, chunk=4,
                                       device="cpu")


def test_smoke_sequence_matches_jax():
    """Warm-up rounded up to a chunk multiple, as the JAX package runs it:
    the same frames within the step test's tolerance."""
    kw = dict(CACHE_CFG)
    jd, jv = jax_smoke.smoke_sequence(jax_smoke.SmokeConfig(**kw), 3,
                                      warmup=3, chunk=2)
    td, tv = smoke.smoke_sequence(smoke.SmokeConfig(**kw), 3, warmup=3,
                                  chunk=2, device="cpu")
    assert td.shape == jd.shape and tv.shape == jv.shape
    np.testing.assert_allclose(td, jd, atol=1e-5 * float(np.abs(jd).max()))
    np.testing.assert_allclose(tv, jv, atol=1e-5 * float(np.abs(jv).max()))


@pytest.mark.parametrize("halo", [1, 3])
def test_port_chunk_dir_reads_the_same_in_both_packages(tmp_path, halo):
    cfg = smoke.SmokeConfig(**CACHE_CFG)
    path = str(tmp_path / "seq")
    assert smoke.smoke_sequence_cached(cfg, 7, path, chunk=3, device="cpu")
    assert jax_stream.sequence_cache_complete(path)
    ours = list(stream.iter_sequence_blocks(path, halo))
    theirs = list(jax_stream.iter_sequence_blocks(path, halo))
    assert [b[0] for b in ours] == [b[0] for b in theirs] == [0, 3, 6]
    for (_, d0, v0), (_, d1, v1) in zip(ours, theirs):
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(v0, v1)
        assert v0.shape[0] == d0.shape[0] + 2 * halo
    ref_d, _ = smoke.smoke_sequence(cfg, 7, chunk=3, device="cpu")
    np.testing.assert_array_equal(np.concatenate([b[1] for b in ours]),
                                  ref_d)


def test_uni_files_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    d = rng.random((5, 4, 6), dtype=np.float32)
    v = rng.standard_normal((5, 4, 6, 3)).astype(np.float32)
    write_uni(str(tmp_path / "d.uni"), d)
    jax_write_uni(str(tmp_path / "v.uni"), v)
    np.testing.assert_array_equal(jax_read_uni(str(tmp_path / "d.uni"))[0],
                                  d)
    got, header = read_uni(str(tmp_path / "v.uni"))
    np.testing.assert_array_equal(got, v)
    assert header.magic == "MNT3" and header.dim == (6, 4, 5)


def test_manifest_cross_read(tmp_path):
    out = tmp_path / "d_0003.npz"
    out.write_bytes(b"x")
    SequenceManifest(str(tmp_path / "m.json")).mark(3, str(out), wall_s=1.0)
    jm = JaxManifest(str(tmp_path / "m.json"))
    assert jm.done(3) and not jm.done(4)
    jm.mark(4, str(tmp_path / "missing.npz"))
    tm = SequenceManifest(str(tmp_path / "m.json"))
    assert tm.done(3) and not tm.done(4)  # frame 4's output is missing
    assert os.path.exists(str(tmp_path / "m.json"))
