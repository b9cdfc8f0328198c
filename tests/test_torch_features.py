"""nfs_tpu_torch VGG features and losses against the JAX package on the
CPU, with the JAX package's weights carried across; the loaders' dtype
and the features' precision, as the JAX functions take them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.features.losses import gram_matrix as jax_gram
from nfs_tpu.features.losses import style_loss as jax_style_loss
from nfs_tpu.features.vgg import get_vgg_params as jax_get
from nfs_tpu.features.vgg import init_vgg_params as jax_init
from nfs_tpu.features.vgg import load_vgg_params as jax_load
from nfs_tpu.features.vgg import save_vgg_params as jax_save
from nfs_tpu.features.vgg import vgg_features as jax_vgg
from nfs_tpu_torch.features.losses import gram_matrix, style_loss
from nfs_tpu_torch.features.vgg import (
    get_vgg_params, init_vgg_params, load_vgg_params, params_from_numpy,
    save_vgg_params, vgg_features)

torch.set_num_threads(2)

LAYERS = ("relu1_1", "relu2_1", "relu3_1")


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(0)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).random((2, 24, 20, 3), dtype=np.float32)


@pytest.mark.parametrize("pool", ["avg", "max"])
def test_vgg_features_f32(weights, images, pool):
    jparams, tparams = weights
    want = jax_vgg(jparams, jnp.asarray(images), LAYERS, pool=pool,
                   precision=jax.lax.Precision.HIGHEST)
    got = vgg_features(tparams, torch.from_numpy(images), LAYERS, pool=pool)
    for layer in LAYERS:
        w = np.asarray(want[layer])
        g = got[layer].numpy()
        assert g.shape == w.shape
        # f32 convolutions summed in another order
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_vgg_features_bf16(weights, images):
    jparams, tparams = weights
    want = jax_vgg(jparams, jnp.asarray(images), LAYERS,
                   dtype=jnp.bfloat16)
    got = vgg_features(tparams, torch.from_numpy(images), LAYERS,
                       dtype=torch.bfloat16)
    for layer in LAYERS:
        w = np.asarray(want[layer].astype(jnp.float32))
        g = got[layer].float().numpy()
        assert got[layer].dtype == torch.bfloat16
        # bf16 keeps 8 mantissa bits (~4e-3 relative per rounding), and
        # the two frameworks round at different places in the stack
        np.testing.assert_allclose(g, w, rtol=2e-2,
                                   atol=2e-2 * np.abs(w).max())


def test_gram_and_style_loss(weights, images):
    jparams, tparams = weights
    jfeats = jax_vgg(jparams, jnp.asarray(images), LAYERS,
                     precision=jax.lax.Precision.HIGHEST)
    tfeats = {k: torch.from_numpy(np.array(v)) for k, v in jfeats.items()}
    for layer in LAYERS:
        np.testing.assert_allclose(gram_matrix(tfeats[layer]).numpy(),
                                   np.asarray(jax_gram(jfeats[layer])),
                                   rtol=1e-4, atol=1e-7)
    rng = np.random.default_rng(1)
    targets = {l: rng.random((tfeats[l].shape[-1],) * 2).astype(np.float32)
               * 1e-2 for l in LAYERS}
    weights_ = (1.0, 0.5, 2.0)
    want = float(jax_style_loss(
        jfeats, {k: jnp.asarray(v) for k, v in targets.items()}, LAYERS,
        weights_))
    got = float(style_loss(
        tfeats, {k: torch.from_numpy(v) for k, v in targets.items()},
        LAYERS, weights_))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_params_round_trip(weights, tmp_path):
    """JAX save -> port load -> port save -> JAX load is the identity."""
    jparams, _ = weights
    jax_save(str(tmp_path / "a.npz"), jparams)
    tparams = load_vgg_params(str(tmp_path / "a.npz"))
    assert tuple(tparams["conv2_1"]["w"].shape) == (128, 64, 3, 3)  # OIHW
    save_vgg_params(str(tmp_path / "b.npz"), tparams)
    back = jax_load(str(tmp_path / "b.npz"))
    for name, p in jparams.items():
        np.testing.assert_array_equal(np.asarray(back[name]["w"]),
                                      np.asarray(p["w"]))
        np.testing.assert_array_equal(np.asarray(back[name]["b"]),
                                      np.asarray(p["b"]))


def test_random_init_is_he_normal():
    params = init_vgg_params(seed=0)
    again = init_vgg_params(seed=0)
    w = params["conv3_1"]["w"]
    assert tuple(w.shape) == (256, 128, 3, 3)
    assert torch.equal(w, again["conv3_1"]["w"])
    expect = np.sqrt(2.0 / (9 * 128))
    assert abs(float(w.std()) - expect) < 0.05 * expect


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loaders_take_dtype_as_jax(weights, tmp_path, dtype):
    """init, load and get store their weights as ``dtype``, as the JAX
    loaders do: a file's weights are the float32 ones cast, the random
    init is the float32 draw cast."""
    jparams, _ = weights
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    path = str(tmp_path / "w.npz")
    jax_save(path, jparams)
    want = jax_get(path, dtype=jdt)
    for params in (load_vgg_params(path, dtype=tdt),
                   get_vgg_params(path, dtype=tdt)):
        for name, p in want.items():
            for k in ("w", "b"):
                assert params[name][k].dtype == tdt
                w = params[name][k].float().numpy()
                if k == "w":
                    w = w.transpose(2, 3, 1, 0)     # OIHW -> HWIO
                np.testing.assert_array_equal(
                    w, np.asarray(p[k].astype(jnp.float32)))
    drawn = init_vgg_params(seed=3)
    for params in (init_vgg_params(seed=3, dtype=tdt),
                   get_vgg_params(seed=3, dtype=tdt)):
        for name, p in drawn.items():
            assert params[name]["w"].dtype == tdt
            assert torch.equal(params[name]["w"], p["w"].to(tdt))


@pytest.mark.parametrize("precision", [None, "default", "high", "highest"])
def test_precision_scopes_tf32(weights, images, monkeypatch, precision):
    """``precision`` takes jax.lax.Precision's names: 'highest' runs the
    convolutions with cuDNN's TF32 off, 'default' and 'high' with it on,
    None as torch is set; the switch is restored after the call. On the
    CPU the features are the same (within the f32 tolerance of
    test_vgg_features_f32, against JAX's at HIGHEST)."""
    jparams, tparams = weights
    cudnn, seen = torch.backends.cudnn, []
    conv = torch.nn.functional.conv2d

    def spy(*args, **kw):
        seen.append(cudnn.allow_tf32)
        return conv(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    for before in (False, True):
        monkeypatch.setattr(cudnn, "allow_tf32", before)
        seen.clear()
        got = vgg_features(tparams, torch.from_numpy(images), LAYERS,
                           precision=precision)
        want = {None: before, "default": True, "high": True,
                "highest": False}[precision]
        assert seen and set(seen) == {want}
        assert cudnn.allow_tf32 == before
    jfeats = jax_vgg(jparams, jnp.asarray(images), LAYERS,
                     precision=jax.lax.Precision.HIGHEST)
    for layer in LAYERS:
        w = np.asarray(jfeats[layer])
        np.testing.assert_allclose(got[layer].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    with pytest.raises(ValueError, match="unknown precision"):
        vgg_features(tparams, torch.from_numpy(images), LAYERS,
                     precision="bogus")
    assert cudnn.allow_tf32 == before
