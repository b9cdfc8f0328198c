"""nfs_tpu_torch's 2D renderer, colour compositing and gather rotation
against the JAX package on the CPU: values and gradients of ``render2d``
(both compress modes, grey, with a colour field and with a transfer
function), ``raymarch(color=)``, ``rotate3d`` (in the volume and in the
angles) and ``render_views`` with a transfer function and the gather
rotation.

Inputs are numpy-made from seeds and hold the ties where JAX's
subgradients differ from torch's defaults: densities of exactly 0 (the
0.5 of max(d, 0), F6) and exactly 1 (a clip bound, F2), colours at 0 and
1. Tolerance: 1e-5 of the reference's largest magnitude, for values and
gradients alike (the same f32 sums in another order; measured below
1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.ops.rotate import rotate3d as jax_rotate3d
from nfs_tpu.render import raymarch as JR
from nfs_tpu.render.transfer import COLORMAPS
from nfs_tpu_torch.ops.rotate import rotate3d, rotation_matrix
from nfs_tpu_torch.render import raymarch as TR

torch.set_num_threads(2)

RTOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=RTOL * max(float(np.abs(want).max()), 1e-30))


def _density2d(shape=(20, 14), seed=0):
    rng = np.random.default_rng(seed)
    d = (1.6 * rng.random(shape) - 0.3).astype(np.float32)
    d[:3] = 0.0           # max(d, 0) and clip ties
    d[-2:] = 1.0          # clip's upper bound
    return d


def _color(shape, seed=1):
    c = np.random.default_rng(seed).random(shape + (3,)).astype(np.float32)
    c[0, :, 0] = 0.0
    c[1, :, 1] = 1.0
    return c


@pytest.mark.parametrize("compress", ["soft", "clip"])
@pytest.mark.parametrize("colour", ["gray", "field", "tf"])
def test_render2d_matches_jax(compress, colour):
    d = _density2d()
    col = _color(d.shape) if colour == "field" else None
    tf = COLORMAPS["fire"] if colour == "tf" else None
    gamma = 1.5 if colour == "gray" else 1.0
    out = (24, 18)
    w = np.random.default_rng(2).standard_normal(out + (3,)).astype(
        np.float32)

    def jax_loss(d, col, tf):
        img = JR.render2d(d, out_size=out, gamma=gamma, color=col,
                          compress=compress, tf_nodes=tf, tf_max=1.5)
        return jnp.sum(img * w), img

    args = [jnp.asarray(a) if a is not None else None for a in (d, col, tf)]
    argnums = tuple(i for i, a in enumerate(args) if a is not None)
    (_, jimg), jgrads = jax.value_and_grad(
        jax_loss, argnums=argnums, has_aux=True)(*args)

    targs = [torch.tensor(a, requires_grad=True) if a is not None else None
             for a in (d, col, tf)]
    img = TR.render2d(targs[0], out_size=out, gamma=gamma, color=targs[1],
                      compress=compress, tf_nodes=targs[2], tf_max=1.5)
    (img * torch.from_numpy(w)).sum().backward()
    assert img.shape == out + (3,)
    _close(img.detach().numpy(), jimg)
    for i, jg in zip(argnums, jgrads):
        _close(targs[i].grad.numpy(), jg)


def test_raymarch_color_matches_jax():
    rng = np.random.default_rng(3)
    rho = rng.random((10, 12, 9), dtype=np.float32)
    rho[:, :2] = 0.0
    col = _color(rho.shape, seed=4)
    w = rng.standard_normal((16, 14, 3)).astype(np.float32)

    def jax_loss(rho, col):
        img = JR.raymarch(rho, transmit=0.4, axis=0, out_size=(16, 14),
                          color=col)
        return jnp.sum(img * w), img

    (_, jimg), (jgr, jgc) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(rho),
                                                jnp.asarray(col))
    tr = torch.tensor(rho, requires_grad=True)
    tc = torch.tensor(col, requires_grad=True)
    img = TR.raymarch(tr, transmit=0.4, axis=0, out_size=(16, 14), color=tc)
    (img * torch.from_numpy(w)).sum().backward()
    _close(img.detach().numpy(), jimg)
    _close(tr.grad.numpy(), jgr)
    _close(tc.grad.numpy(), jgc)


def test_rotation_matrix_matches_jax():
    from nfs_tpu.ops.rotate import rotation_matrix as jax_rotation_matrix

    for theta, phi in ((0.3, -0.2), (0.0, 0.0), (-1.1, 0.7)):
        _close(rotation_matrix(torch.tensor(theta), torch.tensor(phi)),
               jax_rotation_matrix(jnp.float32(theta), jnp.float32(phi)))


@pytest.mark.parametrize("theta,phi", [(0.17, -0.08), (-0.35, 0.12)])
def test_rotate3d_matches_jax(theta, phi):
    """Values and the gradients in the volume and in both angles."""
    rng = np.random.default_rng(5)
    d = rng.random((9, 8, 11), dtype=np.float32)
    w = rng.standard_normal(d.shape).astype(np.float32)

    def jax_loss(d, t, p):
        out = jax_rotate3d(d, t, p)
        return jnp.sum(out * w), out

    (_, jout), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(d), jnp.float32(theta), jnp.float32(phi))
    td = torch.tensor(d, requires_grad=True)
    tt = torch.tensor(theta, requires_grad=True)
    tp = torch.tensor(phi, requires_grad=True)
    out = rotate3d(td, tt, tp)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out.detach().numpy(), jout)
    for got, want in zip((td.grad, tt.grad, tp.grad), jgrads):
        _close(got.numpy(), want)


@pytest.mark.parametrize("method", ["gather", "shear"])
def test_render_views_with_transfer_matches_jax(method):
    """A batch of views coloured by a transfer function after the
    rotation; gradients in the density and in the control points."""
    from nfs_tpu_torch.render.camera import poisson_view_pool

    rng = np.random.default_rng(6)
    d = (2.0 * rng.random((10, 9, 12))).astype(np.float32)
    d[:, :2] = 0.0
    views = poisson_view_pool(1, 3, (-10.0, 10.0), (-5.0, 5.0), seed=0)[0]
    nodes = COLORMAPS["viridis"]
    w = rng.standard_normal((3, 16, 14, 3)).astype(np.float32)

    def jax_loss(d, nodes):
        imgs = JR.render_views(d, views[:, 0], views[:, 1], transmit=0.5,
                               out_size=(16, 14), gamma=1.2, method=method,
                               tf_nodes=nodes, tf_max=1.5)
        return jnp.sum(imgs * w), imgs

    (_, jimgs), (jgd, jgn) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(d),
                                                jnp.asarray(nodes))
    td = torch.tensor(d, requires_grad=True)
    tn = torch.tensor(nodes, requires_grad=True)
    vt = torch.from_numpy(views)
    imgs = TR.render_views(td, vt[:, 0], vt[:, 1], transmit=0.5,
                           out_size=(16, 14), gamma=1.2, method=method,
                           tf_nodes=tn, tf_max=1.5)
    (imgs * torch.from_numpy(w)).sum().backward()
    assert imgs.shape == (3, 16, 14, 3)
    _close(imgs.detach().numpy(), jimgs)
    _close(td.grad.numpy(), jgd)
    _close(tn.grad.numpy(), jgn)
