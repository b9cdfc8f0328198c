"""nfs_tpu_torch's quality metrics (``eval/quality.py``) against the JAX
package's on the same numpy inputs, made from seeds.

Tolerance: rtol 1e-5 on every float (float32 reductions of the same
terms in another order; the Gram distance of the random VGG's features is
a mean of squared differences, held to the same relative bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.eval import quality as jq
from nfs_tpu.features.losses import gram_matrix as jax_gram
from nfs_tpu.features.vgg import init_vgg_params, vgg_features
from nfs_tpu_torch.eval import quality as tq
from nfs_tpu_torch.features.vgg import params_from_numpy

torch.set_num_threads(2)

RTOL = 1e-5


def _assert_dicts_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], float), k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


def _sequence(ndim, seed):
    rng = np.random.default_rng(seed)
    shape = (14, 10) if ndim == 2 else (10, 8, 12)
    frames = rng.random((4,) + shape, dtype=np.float32)
    vels = (0.8 * rng.standard_normal((4,) + shape + (ndim,))).astype(
        np.float32)
    return frames, vels


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("max_disp", [2.0, None])
def test_temporal_coherence_matches_jax(ndim, max_disp):
    frames, vels = _sequence(ndim, seed=ndim)
    got = tq.temporal_coherence(torch.from_numpy(frames),
                                torch.from_numpy(vels), max_disp=max_disp)
    want = jq.temporal_coherence(jnp.asarray(frames), jnp.asarray(vels),
                                 max_disp=max_disp)
    _assert_dicts_close(got, want)
    # numpy inputs land on the CPU by default
    _assert_dicts_close(tq.temporal_coherence(frames, vels,
                                              max_disp=max_disp), want)


@pytest.mark.parametrize("stylized,sim,factor", [
    (0.05, 0.02, 3.0), (0.07, 0.02, 3.0), (0.06, 0.02, 3.0),
    (0.5, 0.4, 1.0)])
def test_coherence_gate_matches_jax(stylized, sim, factor):
    got = tq.coherence_gate(stylized, sim, factor=factor)
    assert isinstance(got, bool)
    assert got == jq.coherence_gate(stylized, sim, factor=factor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_distance_matches_jax(dtype):
    vgg_np = jax.tree.map(np.asarray, init_vgg_params(0))
    rng = np.random.default_rng(11)
    images = rng.random((3, 32, 32, 3), dtype=np.float32)
    style = rng.random((1, 32, 32, 3), dtype=np.float32)
    layers = ("relu1_1", "relu2_1", "relu3_1")
    jparams = jax.tree.map(jnp.asarray, vgg_np)
    feats = vgg_features(jparams, jnp.asarray(style), layers)
    targets = {l: np.array(jax_gram(feats[l][0])) for l in layers}
    want = jq.gram_distance(
        jparams, jnp.asarray(images),
        {l: jnp.asarray(g) for l, g in targets.items()}, layers,
        dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    got = tq.gram_distance(
        params_from_numpy(vgg_np), images,
        {l: torch.from_numpy(g) for l, g in targets.items()}, layers,
        dtype=torch.bfloat16 if dtype == "bfloat16" else None)
    assert isinstance(got, float)
    # bf16 convolutions accumulate in another order on the two sides:
    # tests/test_torch_features.py's bf16 feature tolerance, 2e-2
    np.testing.assert_allclose(got, want,
                               rtol=RTOL if dtype == "float32" else 2e-2)


def test_gram_convergence_matches_jax():
    rng = np.random.default_rng(12)
    curves = [np.cumsum(rng.standard_normal(n)).astype(np.float32) + 50.0
              for n in (5, 1, 8)] + [np.zeros(0, np.float32)]
    want = jq.gram_convergence([jnp.asarray(c) for c in curves])
    # the port takes tensors (a styler's octave_losses) or arrays
    assert tq.gram_convergence([torch.from_numpy(c) for c in curves]) == want
    assert tq.gram_convergence(curves) == want


@pytest.mark.parametrize("ndim", [2, 3])
def test_stylization_strength_matches_jax(ndim):
    frames, _ = _sequence(ndim, seed=20 + ndim)
    d, d_star = frames[0], frames[1] * 1.3
    want = jq.stylization_strength(jnp.asarray(d_star), jnp.asarray(d))
    _assert_dicts_close(tq.stylization_strength(torch.from_numpy(d_star),
                                                torch.from_numpy(d)), want)
    _assert_dicts_close(tq.stylization_strength(d_star, d), want)
