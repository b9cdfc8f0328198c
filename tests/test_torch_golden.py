"""nfs_tpu_torch's grid styler against the committed golden outputs of
the JAX package (``tests/golden/golden_2d.npz`` and ``golden_3d.npz``),
with ``test_quality.py``'s metric (mean absolute error over the golden's
mean absolute value) and a bound tighter than its 2e-2.

The inputs of ``tests/golden/make_golden.py`` are recreated here: the
default configuration with its overrides, the blob densities, the JAX
package's random VGG-19 weights (``init_vgg_params(seed 0)``, what its
default ``get_vgg_params`` draws) carried across as numpy, its
``jax.random`` style image, and for 3D the view-pool indices its
``stylize_frame`` draws from ``PRNGKey(3)``, replayed through
``view_schedule`` (the 2D grid is its own image and draws no views).
"""

import os

import jax
import numpy as np
import pytest
import torch

from nfs_tpu.features.vgg import init_vgg_params
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.features.vgg import params_from_numpy
from nfs_tpu_torch.styler.grid import GridStyler
from tests.golden.make_golden import _blob

torch.set_num_threads(2)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
# test_quality.py holds the JAX package to 2e-2; the port is held tighter:
# it lands 5.9e-8 (2D) and 4.5e-8 (3D) from the goldens
BOUND = 1e-5


def _jax_view_schedule(cfg, key):
    """Pool indices of JAX's stylize_frame at window 0 without observers:
    per octave one split, one more in run_octave, one key per iteration,
    each drawing its pool index directly (styler/grid.py _sample_views)."""
    oc = cfg.optim
    out = []
    for _ in range(oc.octave_n):
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        out.append([int(jax.random.randint(k, (), 0, cfg.render.view_pool))
                    for k in jax.random.split(sub, oc.iters)])
    return np.asarray(out)


@pytest.mark.parametrize("name,shape,over", [
    ("golden_2d", (32, 24),
     {"render.render_size": (64, 64), "render.n_views": 2,
      "optim.octave_n": 2, "optim.iters": 8, "optim.lr": 0.02}),
    ("golden_3d", (20, 16, 20),
     {"render.render_size": (64, 64), "render.n_views": 2,
      "render.transmit": 0.05, "optim.octave_n": 2, "optim.iters": 6,
      "optim.lr": 0.02}),
])
def test_port_matches_golden(name, shape, over):
    cfg = replace(StyleConfig(), **over)
    vgg = params_from_numpy(jax.tree.map(np.asarray, init_vgg_params(0)))
    style = np.array(jax.random.uniform(jax.random.PRNGKey(7),
                                          (64, 64, 3)), np.float32)
    styler = GridStyler(cfg, vgg_params=vgg, style_image=style,
                        device="cpu")
    sched = (None if len(shape) == 2
             else _jax_view_schedule(cfg, jax.random.PRNGKey(3)))
    if sched is not None:
        assert len(np.unique(sched)) > 1
    d_star, _, _ = styler.stylize_frame(_blob(shape), view_schedule=sched)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["arr"]
    got = d_star.numpy()
    assert got.shape == golden.shape
    err = np.abs(got - golden).mean() / (np.abs(golden).mean() + 1e-12)
    assert err < BOUND, f"{name}: rel err {err:.4g}"
