"""K2's binned route (``advect_kernels``: ``bin_sources_plain``,
``order_sources``, ``gather_binned_plain``) on the CPU: the layout the
CUDA route builds and the order its gather adds in, held against K2's
``index_add_`` twin and the JAX package's K2 function.

Inputs are made with numpy from a seed. Velocities are large against
max_disp, so most displacements clamp and the backtraces of whole rows
pile onto the grid's clamped walls (the runs of the wall cells hold
many sources). The JAX side is the field gradient of
``advect(impl='xla')`` (the XLA window whose transpose the Pallas K2
computes) at max_disp 1 and 2, and, past the radii whose window compiles
in seconds, of the exact gather path ``advect(max_disp=None)`` on the
displacement clamped to +-max_disp beforehand: the same backtraces, so
the same function. Tolerance 1e-5 absolute: float32 sums of the same
terms in another order (gradients O(1), measured ~1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.ops.advect import advect as jax_advect
from nfs_tpu_torch.ops import advect_kernels as ak

torch.set_num_threads(2)

ATOL = 1e-5
SHAPE = (12, 10, 14)
# max_disp -> scale of the normal velocities (most components clamp)
SCALES = {1.0: 3.0, 2.0: 6.0, 9.0: 6.0, 12.0: 9.0}


def _case(max_disp, shape=SHAPE, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(shape, dtype=np.float32)
    v = (SCALES[max_disp] * rng.standard_normal(shape + (3,))).astype(
        np.float32)
    return g, v


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("max_disp", sorted(SCALES))
def test_layout(max_disp, batch):
    """Every source sits in its floor cell's run, the runs hold their
    sources in ascending source index, and the offsets are the exclusive
    scan of a bincount of the keys; a batch's keys number its frames'
    cells one after another."""
    g, v = _case(max_disp)
    g, v = torch.from_numpy(g), torch.from_numpy(v)
    if batch:
        g, v = torch.stack([g, -g]), torch.stack([v, v.flip(0)])
    keys, rec = ak.bin_sources_plain(v, g, max_disp)
    s = ak.backtrace(v, max_disp)
    D, H, W = SHAPE
    n = keys.numel()
    frame = torch.arange(n).view(g.shape) // (D * H * W)
    want = frame * D * H * W + ((s[0].floor() * H + s[1].floor()) * W
                                + s[2].floor()).long()
    assert keys.dtype == torch.int32 and torch.equal(keys.long(), want)
    assert torch.equal(rec, torch.stack([*s, g], dim=-1))
    perm, offsets = ak.order_sources(keys)
    assert perm.dtype == torch.int64 and offsets.dtype == torch.int32
    counts = torch.bincount(keys.reshape(-1).long(), minlength=n)
    assert torch.equal(offsets.long(), torch.cat(
        [torch.zeros(1, dtype=torch.long), counts.cumsum(0)]))
    assert torch.equal(perm.sort().values, torch.arange(n))
    flat = keys.reshape(-1).long()
    cell = torch.repeat_interleave(torch.arange(n), counts)
    assert torch.equal(flat[perm], cell)        # each source in its run
    same_run = cell[1:] == cell[:-1]
    assert bool((perm[1:] > perm[:-1])[same_run].all())  # ascending
    if max_disp >= 9.0:   # sources pile onto the clamped walls
        assert int(counts.max()) > 8


def _jax_k2(v, g, max_disp):
    """The JAX package's K2 function: the field gradient of advect."""
    if max_disp <= 2.0:
        fn = lambda f: jax_advect(f, jnp.asarray(v), max_disp=max_disp,
                                  impl="xla")
    else:
        vc = jnp.asarray(np.clip(v, -max_disp, max_disp))
        fn = lambda f: jax_advect(f, vc, max_disp=None)
    _, vjp = jax.vjp(fn, jnp.zeros(g.shape, jnp.float32))
    return np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("max_disp", sorted(SCALES))
def test_binned_matches_plain_and_jax(max_disp):
    g, v = _case(max_disp, seed=1)
    got = ak.advect_bwd_field_binned_plain(torch.from_numpy(v),
                                           torch.from_numpy(g), max_disp)
    want = ak.advect_bwd_field_plain(torch.from_numpy(v),
                                     torch.from_numpy(g), max_disp)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_k2(v, g, max_disp),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("max_disp", [2.0, 12.0])
def test_batch_equals_single_frames(max_disp):
    """A B = 3 batch is one sort over the frames' cells and gives the
    bits of three single frames."""
    frames = [_case(max_disp, seed=10 + b) for b in range(3)]
    g = torch.from_numpy(np.stack([f[0] for f in frames]))
    v = torch.from_numpy(np.stack([f[1] for f in frames]))
    batched = ak.advect_bwd_field_binned_plain(v, g, max_disp)
    for b in range(3):
        assert torch.equal(batched[b], ak.advect_bwd_field_binned_plain(
            v[b], g[b], max_disp))


def test_gather_on_one_cell_and_empty_runs():
    """One cell (every floor cell the cell itself) and a zero velocity
    (each run one source, its own cell): the gather returns g."""
    for shape in ((1, 1, 1), (3, 4, 5)):
        g = torch.from_numpy(np.random.default_rng(2).standard_normal(
            shape).astype(np.float32))
        v = torch.zeros(shape + (3,))
        assert torch.equal(ak.advect_bwd_field_binned_plain(v, g, 9.0), g)
