"""nfs_tpu_torch resize (every ``jax.image.resize`` method), shear
rotation (one view, a batch of views), camera pool and renderer against
the JAX package on the CPU, from the same numpy-made inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.ops.shear import rotate3d_shear as jax_rotate3d_shear
from nfs_tpu.ops.shear import rotate3d_shear_batch as jax_shear_batch
from nfs_tpu.render.camera import poisson_view_pool as jax_pool
from nfs_tpu.render.raymarch import render_views as jax_render_views
from nfs_tpu_torch.ops.resize import octave_shapes, resize, weight_matrix
from nfs_tpu_torch.ops.shear import rotate3d_shear, rotate3d_shear_batch
from nfs_tpu_torch.render.camera import (
    poisson_view_pool, sample_views_stratified)
from nfs_tpu_torch.render.raymarch import render_views

torch.set_num_threads(2)


@pytest.mark.parametrize("src,dst", [
    ((112, 64, 112), (62, 36, 62)),   # octave downsample (antialiased)
    ((16, 12, 16), (9, 7, 9)),
    ((9, 7, 9), (16, 12, 16)),        # upsample
    ((20, 11, 7), (20, 5, 13)),       # mixed, one axis unchanged
])
@pytest.mark.parametrize("velocity", [False, True])
def test_resize_matches_jax(src, dst, velocity):
    from nfs_tpu.ops.resize import resize as jax_resize

    rng = np.random.default_rng(0)
    x = rng.random(src + ((3,) if velocity else ()), dtype=np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst, is_velocity=velocity))
    got = resize(torch.from_numpy(x), dst, is_velocity=velocity).numpy()
    # same weights, contracted in another order: float32 rounding only
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


METHODS = ("nearest", "linear", "cubic", "lanczos3", "lanczos5")
ALIASES = ("bilinear", "trilinear", "triangle", "bicubic", "tricubic")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("src", [(20, 16), (20, 16, 12)], ids=["2d", "3d"])
@pytest.mark.parametrize("factor", [1 / 1.8, 1.8], ids=["down", "up"])
def test_resize_methods_match_jax(method, src, factor):
    """``resize(method=)`` against the JAX package's, which calls
    ``jax.image.resize``: nearest bitwise, every kernel method
    antialiased alike. Linear within 1e-6; the cubic and Lanczos kernels
    within 2e-6: jax builds its weight matrices inside jit, where XLA
    fuses the kernel's polynomial and rounds it otherwise (measured up to
    1.07e-6 for cubic, 3D, up by 1.8; the port's weights are the eager
    formula's, test_resize_weights_are_jax_formula)."""
    from nfs_tpu.ops.resize import resize as jax_resize

    dst = tuple(int(round(s * factor)) for s in src)
    x = np.random.default_rng(0).random(src, dtype=np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), dst, method=method))
    got = resize(torch.from_numpy(x), dst, method=method).numpy()
    assert got.shape == want.shape == dst
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 if method == "linear" else 2e-6)


@pytest.mark.parametrize("alias", ALIASES)
def test_resize_aliases_are_jax_aliases(alias):
    """Each alias names the method jax.image's ResizeMethod maps it to,
    and resizes bitwise as that method (both packages resolve the name
    before they build weights)."""
    from jax._src.image.scale import ResizeMethod

    method = ResizeMethod.from_string(alias).name.lower()
    x = torch.from_numpy(np.random.default_rng(1).random(
        (20, 16, 12), dtype=np.float32))
    for dst in ((11, 9, 7), (36, 29, 22)):
        np.testing.assert_array_equal(resize(x, dst, method=alias),
                                      resize(x, dst, method=method))


@pytest.mark.parametrize("method", ["linear", "cubic", "lanczos3",
                                    "lanczos5"])
@pytest.mark.parametrize("sizes", [(20, 11), (16, 29), (7, 7)])
def test_resize_weights_are_jax_formula(method, sizes):
    """The (in, out) weight matrix is ``compute_weight_mat`` of
    ``jax/_src/image/scale.py`` run eagerly: bitwise for the triangle
    and cubic kernels; the Lanczos kernels' sines (numpy's against XLA's)
    within 2e-7."""
    from jax._src.image import scale

    kernel = {"linear": scale._fill_triangle_kernel,
              "cubic": scale._fill_keys_cubic_kernel,
              "lanczos3": lambda x: scale._fill_lanczos_kernel(3.0, x),
              "lanczos5": lambda x: scale._fill_lanczos_kernel(5.0, x)}
    m, n = sizes
    # scale and translation as jax.image.resize passes them: Python floats
    want = np.asarray(scale.compute_weight_mat(m, n, n / m, 0.0,
                                               kernel[method], True))
    got = weight_matrix(m, n, method)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-7 if "lanczos" in method else 0)


def test_unknown_resize_method_raises_as_jax():
    from nfs_tpu.ops.resize import resize as jax_resize

    with pytest.raises(ValueError) as jax_err:
        jax_resize(jnp.zeros((4, 4)), (2, 2), method="bogus")
    with pytest.raises(ValueError) as err:
        resize(torch.zeros(4, 4), (2, 2), method="bogus")
    assert str(err.value) == str(jax_err.value)


def test_octave_shapes_match():
    from nfs_tpu.ops.resize import octave_shapes as jax_octave_shapes

    for shape in [(112, 64, 112), (16, 12, 16)]:
        assert octave_shapes(shape, 3, 1.8) == jax_octave_shapes(shape, 3,
                                                                 1.8)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_rotate3d_shear_matches_jax(dtype):
    rng = np.random.default_rng(1)
    d = rng.random((14, 10, 12), dtype=np.float32)
    thetas = np.array([0.15, -0.1, 0.0], np.float32)
    phis = np.array([-0.07, 0.05, 0.0], np.float32)
    jdt = jnp.bfloat16 if dtype else None
    tdt = torch.bfloat16 if dtype else None
    want = np.stack([np.asarray(jax_rotate3d_shear(jnp.asarray(d), t, p,
                                                   dtype=jdt))
                     for t, p in zip(thetas, phis)])
    got = rotate3d_shear(torch.from_numpy(d), torch.from_numpy(thetas),
                         torch.from_numpy(phis), dtype=tdt).numpy()
    # float32 accumulation in another order (bf16 operands round the same
    # way in both packages)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    one = rotate3d_shear(torch.from_numpy(d), float(thetas[0]),
                         float(phis[0]), dtype=tdt).numpy()
    np.testing.assert_allclose(one, want[0], atol=1e-5, rtol=0)


def test_rotate3d_shear_batch_matches_jax():
    """One volume by a batch of angle pairs, against the JAX package's
    vmap of rotate3d_shear (same tolerance as above)."""
    rng = np.random.default_rng(2)
    d = rng.random((12, 10, 14), dtype=np.float32)
    thetas = np.array([0.2, -0.15, 0.0, 0.4], np.float32)
    phis = np.array([0.05, -0.1, 0.0, 0.1], np.float32)
    want = np.asarray(jax_shear_batch(jnp.asarray(d), jnp.asarray(thetas),
                                      jnp.asarray(phis)))
    got = rotate3d_shear_batch(torch.from_numpy(d), thetas, phis).numpy()
    assert got.shape == want.shape == (4, 12, 10, 14)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        got, rotate3d_shear(torch.from_numpy(d), torch.from_numpy(thetas),
                            torch.from_numpy(phis)).numpy())


def test_poisson_pool_identical():
    args = (8, 9, (-10.0, 10.0), (-5.0, 5.0))
    np.testing.assert_array_equal(poisson_view_pool(*args, seed=3),
                                  jax_pool(*args, seed=3))


def test_stratified_views_in_range():
    views = sample_views_stratified(torch.Generator().manual_seed(0), 9,
                                    (-10.0, 10.0), (-5.0, 5.0))
    assert views.shape == (9, 2)
    lim = torch.tensor([np.radians(10.0), np.radians(5.0)])
    assert bool((views.abs() <= lim + 1e-6).all())


def test_render_views_value_and_grad():
    """Values and the volume gradient of the batched renderer for one pool
    entry; the density has exact zeros, where both packages take the 0.5
    subgradient of max(rho, 0)."""
    rng = np.random.default_rng(2)
    d = rng.random((12, 10, 14), dtype=np.float32)
    d[:, :3] = 0.0
    views = poisson_view_pool(1, 3, (-10.0, 10.0), (-5.0, 5.0), seed=0)[0]
    w = rng.standard_normal((3, 24, 20, 3), dtype=np.float32)

    def jax_loss(d):
        imgs = jax_render_views(d, views[:, 0], views[:, 1], transmit=0.5,
                                out_size=(24, 20), gamma=1.5)
        return jnp.sum(imgs * w), imgs

    (_, jimgs), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(d))
    dt = torch.tensor(d, requires_grad=True)
    vt = torch.from_numpy(views)
    imgs = render_views(dt, vt[:, 0], vt[:, 1], transmit=0.5,
                        out_size=(24, 20), gamma=1.5)
    (imgs * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(imgs.detach().numpy(), np.asarray(jimgs),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-5, rtol=0)
