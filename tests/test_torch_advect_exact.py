"""nfs_tpu_torch's exact advection path (``max_disp=None``) against the JAX
package on the CPU: ``advect``, ``advect_maccormack`` with its corner
limiter, and ``advect_chain``, in 2D and 3D, clamp and zero modes, scalar
and channelled fields; then a W=1 grid sequence with ``optim.max_disp``
and ``optim.param_max_disp`` None through both packages' ``GridStyler``.

Inputs are made with numpy from a seed and fed to both sides.

Tolerances: values and gradients atol 1e-5. Both sides run the same
float32 arithmetic (the JAX custom VJP of ``grid_sample`` written out in
``ops/interp.py``); only the order of the field gradient's scatter-add
sums may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfs_tpu.core.config import StyleConfig as JaxStyleConfig
from nfs_tpu.core.config import replace as jax_replace
from nfs_tpu.features.vgg import init_vgg_params
from nfs_tpu.ops.advect import advect as jax_advect
from nfs_tpu.ops.advect import advect_chain as jax_advect_chain
from nfs_tpu.ops.advect import advect_maccormack as jax_maccormack
from nfs_tpu.styler.grid import GridStyler as JaxGridStyler
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.features.vgg import params_from_numpy
from nfs_tpu_torch.ops.advect import advect, advect_chain, advect_maccormack
from nfs_tpu_torch.styler.grid import GridStyler

torch.set_num_threads(2)

ATOL = 1e-5
SHAPES = {2: (9, 7), 3: (7, 6, 8)}


def _case(ndim, channels, seed, scale=1.5):
    """Field, velocity (up to a few cells, many backtraces leaving the
    grid) and loss weights of the output."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[ndim]
    fshape = shape + ((channels,) if channels else ())
    f = rng.random(fshape, dtype=np.float32)
    v = (scale * rng.standard_normal(shape + (ndim,))).astype(np.float32)
    w = rng.standard_normal(fshape).astype(np.float32)
    return f, v, w


def _torch_value_and_grads(fn, f, v, w):
    ft = torch.tensor(f, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    out = fn(ft, vt)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), ft.grad.numpy(), vt.grad.numpy()


def _jax_value_and_grads(fn, f, v, w):
    out = np.asarray(fn(jnp.asarray(f), jnp.asarray(v)))
    gf, gv = jax.grad(lambda a, b: jnp.sum(fn(a, b) * w), argnums=(0, 1))(
        jnp.asarray(f), jnp.asarray(v))
    return out, np.asarray(gf), np.asarray(gv)


def _assert_close(got, want):
    for name, t, j in zip(("value", "grad field", "grad vel"), got, want):
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("mode", ["clamp", "zero"])
@pytest.mark.parametrize("channels", [0, 2])
def test_advect_exact_matches_jax(ndim, mode, channels):
    f, v, w = _case(ndim, channels, seed=ndim * 10 + channels)
    got = _torch_value_and_grads(
        lambda a, b: advect(a, b, dt=0.8, mode=mode, max_disp=None), f, v, w)
    want = _jax_value_and_grads(
        lambda a, b: jax_advect(a, b, dt=0.8, mode=mode, max_disp=None),
        f, v, w)
    _assert_close(got, want)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("mode", ["clamp", "zero"])
@pytest.mark.parametrize("channels", [0, 3])
def test_maccormack_exact_matches_jax(ndim, mode, channels):
    f, v, w = _case(ndim, channels, seed=100 + ndim * 10 + channels)
    got = _torch_value_and_grads(
        lambda a, b: advect_maccormack(a, b, mode=mode, max_disp=None),
        f, v, w)
    want = _jax_value_and_grads(
        lambda a, b: jax_maccormack(a, b, mode=mode, max_disp=None), f, v, w)
    _assert_close(got, want)


@pytest.mark.parametrize("ndim", [2, 3])
def test_maccormack_limiter_ties_split_gradient(ndim):
    """Zero velocity: every output equals its cell's value, which is also
    corner (0, ..., 0) of the limiter, so the clip meets a tie at every
    cell. JAX's clip splits the gradient 0.5/0.5 there: half reaches the
    field through the gathered corner, which carries no velocity
    gradient, so the velocity gradient is halved where a bound ties. A
    clamp that gives the whole gradient to ``out`` (torch.clamp's rule)
    would keep the unlimited velocity gradient."""
    f, _, w = _case(ndim, 0, seed=7)
    v = np.zeros(SHAPES[ndim] + (ndim,), np.float32)
    got = _torch_value_and_grads(
        lambda a, b: advect_maccormack(a, b, max_disp=None), f, v, w)
    want = _jax_value_and_grads(
        lambda a, b: jax_maccormack(a, b, max_disp=None), f, v, w)
    np.testing.assert_array_equal(got[0], f)
    _assert_close(got, want)

    def unlimited(a, b):
        fwd = advect(a, b, max_disp=None)
        return fwd + 0.5 * (a - advect(fwd, b, dt=-1.0, max_disp=None))

    whole = _torch_value_and_grads(unlimited, f, v, w)
    assert np.abs(got[2] - whole[2]).max() > 0.1


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("max_disp", [None, 2.0])
def test_advect_chain_matches_jax(ndim, max_disp):
    rng = np.random.default_rng(40 + ndim)
    shape = SHAPES[ndim]
    f = rng.random(shape, dtype=np.float32)
    vels = (0.9 * rng.standard_normal((3,) + shape + (ndim,))).astype(
        np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    got = _torch_value_and_grads(
        lambda a, b: advect_chain(a, b, dt=0.5, max_disp=max_disp),
        f, vels, w)
    want = _jax_value_and_grads(
        lambda a, b: jax_advect_chain(a, b, dt=0.5, max_disp=max_disp),
        f, vels, w)
    # with max_disp the 3D chain runs K1-K3's plain twins against the
    # XLA window sum (other summation order): tests/test_torch_advect.py's
    # gradient tolerance
    atol = ATOL if max_disp is None or ndim == 2 else 1e-4
    for t, j in zip(got, want):
        np.testing.assert_allclose(t, j, atol=atol, rtol=0)


SEQ_SHAPE = (12, 10, 12)
SEQ_OVER = {
    "render.render_size": (32, 32),
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 1,
    "render.transmit": 0.5,
    "loss.style_layers": ("relu1_1", "relu2_1"),
    "loss.style_layer_weights": (1.0, 1.0),
    # at w_style 1 the random VGG's ~1e-8 gradients meet Adam's eps and
    # f32 rounding turns into whole steps (tests/test_torch_grid2d.py)
    "loss.w_style": 1000.0,
    "optim.octave_n": 2,
    "optim.octave_scale": 2.0,
    "optim.iters": 2,
    "optim.lr": 0.02,
    "optim.window": 1,
    "optim.log_every": 1,
    "optim.max_disp": None,
    "optim.param_max_disp": None,
}


def _exact_inputs():
    rng = np.random.default_rng(3)
    style = rng.random((32, 32, 3), dtype=np.float32)
    ds = (2.0 * rng.random((2,) + SEQ_SHAPE)).astype(np.float32)
    # up to ~4 cells: beyond any window bound the config could set
    vs = (1.5 * rng.standard_normal((2,) + SEQ_SHAPE + (3,))).astype(
        np.float32)
    return style, ds, vs


@pytest.fixture(scope="module")
def vgg_np():
    return jax.tree.map(np.asarray, init_vgg_params(0))


def _exact_stylers(vgg_np, **over):
    over = dict(SEQ_OVER, **over)
    style = _exact_inputs()[0]
    js = JaxGridStyler(jax_replace(JaxStyleConfig(), **over),
                       vgg_params=jax.tree.map(jnp.asarray, vgg_np),
                       style_image=style)
    ts = GridStyler(replace(StyleConfig(), **over),
                    vgg_params=params_from_numpy(vgg_np),
                    style_image=style, device="cpu")
    return js, ts


@pytest.mark.parametrize("parameterization", ["density", "velocity"])
def test_exact_window_loss_value_and_grad(vgg_np, parameterization):
    """The W=1 loss of either parameterization on the exact path: the
    window states (max_disp None) and, for the velocity one, the apply
    (param_max_disp None), at a random param, in value and gradient."""
    js, ts = _exact_stylers(vgg_np,
                            **{"optim.parameterization": parameterization})
    _, ds, vs = _exact_inputs()
    rng = np.random.default_rng(4)
    if parameterization == "velocity":
        param = (0.8 * rng.standard_normal(SEQ_SHAPE + (3,))).astype(
            np.float32)
    else:
        param = (0.05 * rng.standard_normal(SEQ_SHAPE)).astype(np.float32)
    vels = np.stack([vs[0], vs[1]])
    jdata = {"d": jnp.asarray(ds[0]), "pool": js.view_pool,
             "vgg": js.vgg_params, "targets": js.gram_targets,
             "content": None, "vels": jnp.asarray(vels)}
    jl, jg = jax.value_and_grad(js._get_loss_fn(3, 1, (32, 32)))(
        jnp.asarray(param), jax.random.PRNGKey(0), jdata)
    tdata = {"d": torch.from_numpy(ds[0]), "pool": ts.view_pool,
             "vgg": ts.vgg_params, "targets": ts.gram_targets,
             "content": None, "vels": torch.from_numpy(vels)}
    p = torch.tensor(param, requires_grad=True)
    tl = ts._get_loss_fn(3, 1, (32, 32))(p, [ts.view_pool[0]] * 3, tdata)
    (tg,) = torch.autograd.grad(tl, p)
    # as tests/test_torch_styler.py's window-loss test: the same f32 sums
    # in another order
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg,
                               atol=1e-5 * float(np.abs(jg).max()))


def test_exact_sequence_matches_jax(vgg_np):
    """Two W=1 frames of the density parameterization on the exact path:
    the window states and the MacCormack warm start take max_disp=None.

    The velocity parameterization is held by the loss test above, not
    through Adam: on the exact path its coordinate gradient jumps where a
    backtrace crosses a cell index (the sample's corners change), and the
    param starts at zero, where every backtrace sits on one. 1e-10
    differences of the octave resize near zero then flip corners at the
    grid's low faces, and Adam's normalised steps turn that into whole
    steps (measured 3e-4 relative in the third loss)."""
    js, ts = _exact_stylers(vgg_np)
    _, ds, vs = _exact_inputs()
    jlosses = []
    jouts = [(np.asarray(d), np.asarray(p)) for _, d, p in
             js.stylize_sequence(
                 ds, vs, fused=0,
                 callback=lambda done, loss, octave: jlosses.append(loss))]
    tlosses = []
    touts = [(d.numpy(), p.numpy()) for _, d, p in
             ts.stylize_sequence(
                 ds, vs, fused=0,
                 callback=lambda done, loss, octave: tlosses.append(loss))]
    assert len(tlosses) == len(jlosses) == 2 * 2 * 2
    # as tests/test_torch_styler.py's sequence test: f32 rounding carried
    # through 8 Adam steps; fields within 1e-3 of a 0.16 worst case
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    for (td, tp), (jd, jp) in zip(touts, jouts):
        assert td.shape == jd.shape == SEQ_SHAPE
        assert np.abs(td - jd).max() <= 1e-3
        assert np.abs(tp - jp).max() <= 1e-3
