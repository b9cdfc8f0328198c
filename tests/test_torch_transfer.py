"""nfs_tpu_torch's transfer functions against the JAX package on the
CPU: the builtin colormaps, ``transfer_colors`` (values and gradients in
the density and in the control points), ``tf_from_image`` and
``resolve_transfer``.

The densities hold exact 0, exact multiples of d_max / (N - 1) (the hat
basis' kinks, where abs'(0) = +1 and max(0, .) ties take 0.5, F1 and F6)
and values past d_max (the clip's flat part and its bound, F2).
Tolerance: 1e-5 of the reference's largest magnitude (the same f32 sums;
measured equal to the bit here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.render import transfer as JT
from nfs_tpu_torch.render import transfer as TT

torch.set_num_threads(2)

RTOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=RTOL * max(float(np.abs(want).max()), 1e-30))


def test_colormaps_are_the_jax_tables():
    assert sorted(TT.COLORMAPS) == sorted(JT.COLORMAPS)
    for name, table in JT.COLORMAPS.items():
        np.testing.assert_array_equal(TT.COLORMAPS[name], table)
        assert TT.COLORMAPS[name].dtype == np.float32


@pytest.mark.parametrize("name,d_max", [("fire", 2.0), ("viridis", 0.7),
                                        ("gray", 1.0)])
def test_transfer_colors_value_and_grads(name, d_max):
    rng = np.random.default_rng(0)
    n = JT.COLORMAPS[name].shape[0]
    rho = (1.3 * d_max * rng.random((6, 7, 5))).astype(np.float32)
    # kinks of the hat basis, the clip's bounds and beyond
    rho.flat[:n + 3] = np.float32(d_max) * np.concatenate(
        [np.arange(n) / (n - 1), [1.5, 0.0, 2.0]]).astype(np.float32)
    nodes = (JT.COLORMAPS[name]
             + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    w = rng.standard_normal(rho.shape + (3,)).astype(np.float32)

    def jax_loss(rho, nodes):
        c = JT.transfer_colors(rho, nodes, d_max)
        return jnp.sum(c * w), c

    (_, jc), (jgr, jgn) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(rho),
                                                jnp.asarray(nodes))
    tr = torch.tensor(rho, requires_grad=True)
    tn = torch.tensor(nodes, requires_grad=True)
    c = TT.transfer_colors(tr, tn, d_max)
    (c * torch.from_numpy(w)).sum().backward()
    assert c.shape == rho.shape + (3,)
    _close(c.detach().numpy(), jc)
    _close(tr.grad.numpy(), jgr)
    _close(tn.grad.numpy(), jgn)


def test_tf_from_image_and_resolve_match_jax(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    img = (rng.random((9, 40, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "ramp.png")
    pil.fromarray(img).save(path)
    for n in (8, 5):
        np.testing.assert_array_equal(TT.tf_from_image(path, n),
                                      JT.tf_from_image(path, n))
    np.savez(tmp_path / "tf.npz", nodes=JT.COLORMAPS["ice"] * 0.5)
    for name in ("fire", path, str(tmp_path / "tf.npz")):
        np.testing.assert_array_equal(TT.resolve_transfer(name),
                                      JT.resolve_transfer(name))
    assert TT.resolve_transfer(None) is None
    assert TT.resolve_transfer("") is None
