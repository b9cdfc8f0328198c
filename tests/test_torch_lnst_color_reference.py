"""nfs_tpu_torch's LNST colour job (``ParticleStyler.stylize_keyframes``
with ``particle.optimize_color``) against the plain reference of the
benchmark's colour cell (``benchmark/reference/lnst_color.py``) on the
CPU, at a small size, on seeded random VGG weights: keyframes 0, 2 and 4
of a 5-frame job, each warm-started from the one before, the grid-space
coarse octave, the finest octave binned (the 5-channel pass) or flat, and
the interpolated frames 1 and 3. Colours of two fluids, with channels
exactly at 0 and 1 (the clip's ties, gradient 1/2 there) or strictly
inside.

Tolerances: the reference sums the splat by ``index_add`` and the
program by shifted dense adds, and the two order the render's sums
differently, so float32 rounding parts them from the first iteration.
Losses within 1e-4 relative (worst seen 1.9e-6). Positions, densities
and colours by the benchmark's gap, ||got - want|| / ||want - input||
over a frame's particles, within 2e-3: worst seen 4.0e-4 (flat route,
colours strictly inside, densities of keyframe 0), where a few particles'
gradients cross zero within an octave and Adam's normalized step turns
their rounding into part of a step while the losses agree to 2e-6; a
clip whose gradient is 1 at its ties in place of 1/2 reads 1.1e-2 in the
colours of keyframe 0. Float32 features: bfloat16 would round the two
sides' small differences into whole bfloat16 steps.

The reference imports nothing of the port and no JAX: a fresh
interpreter that imports it holds neither in ``sys.modules``.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference.lnst_color import LnstColor
from nfs_tpu_torch.core.config import StyleConfig, replace
from nfs_tpu_torch.core.pytrees import ParticleSet
from nfs_tpu_torch.styler.particle import ParticleStyler

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 11
GRID = (16, 12, 16)
N, T, STRIDE = 600, 5, 2
STYLE = {
    "render.render_size": [32, 32],
    "render.min_render_size": 16,
    "render.n_views": 2,
    "render.view_pool": 4,
    "render.transmit": 0.5,
    "loss.style_layers": ["relu1_1", "relu2_1"],
    "loss.style_layer_weights": [1.0, 1.0],
    "loss.features_dtype": "float32",
    "loss.w_style": 1000.0,
    "optim.octave_n": 2,
    "optim.octave_scale": 1.8,
    "optim.iters": 3,
    "optim.lr": 0.02,
    "optim.log_every": 10,
    "particle.optimize_position": True,
    "particle.optimize_density": True,
    "particle.optimize_color": True,
    "particle.keyframe_stride": STRIDE,
    "particle.kernel": "bspline",
    "particle.support": 1.0,
    "particle.max_offset": 4.0,
    "particle.rebin_every": 2,
    "particle.coarse_mode": "grid",
    "particle.k_budget": 0.001,
    "particle.max_bin_slots": 64000000,
}
LOSS_RTOL = 1e-4
GAP = 2e-3


def _gap(got, want, base) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want - base))


def _job(ties: bool):
    rng = np.random.default_rng(5)
    x0 = rng.random((N, 3)) * (np.asarray(GRID) - 4.0) + 2.0
    drift = rng.normal(size=(N, 3)) * 0.1
    xs = torch.tensor(np.stack([x0 + t * drift for t in range(T)]),
                      dtype=torch.float32)
    if ties:    # two fluids, the noise clipped: channels at exactly 0 and 1
        base = np.where(x0[:, 2:] < GRID[2] / 2, [0.95, 0.45, 0.05],
                        [0.05, 0.35, 0.95])
        color = np.clip(base + rng.uniform(-0.1, 0.1, (N, 3)), 0.0, 1.0)
        assert (color == 0).any() and (color == 1).any()
    else:
        color = rng.uniform(0.1, 0.9, (N, 3))
    sched = np.random.default_rng(6).integers(
        0, STYLE["render.view_pool"],
        (len(range(0, T, STRIDE)), STYLE["optim.octave_n"],
         STYLE["optim.iters"]))
    return xs, torch.tensor(color, dtype=torch.float32), sched


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "inside"])
@pytest.mark.parametrize("route", ["binned", "flat"])
def test_colour_job_matches_the_reference(route, ties):
    sc = dict(STYLE, **{"particle.splat_impl":
                        "auto" if route == "binned" else "flat"})
    xs, color, sched = _job(ties)
    dens = torch.ones(N)
    vgg = inputs.vgg_weights(SEED, sc["loss.style_layers"], device="cpu")
    style = np.random.default_rng(1).random((32, 32, 3), dtype=np.float32)

    styler = ParticleStyler(replace(StyleConfig(), seed=SEED, **sc),
                            grid_shape=GRID, vgg_params=vgg,
                            style_image=style, device="cpu")
    got = {t: (p.x, p.dens, p.color) for t, p in styler.stylize_keyframes(
        [ParticleSet(x=x, dens=dens, color=color) for x in xs],
        view_schedule=sched)}
    got_losses = [torch.stack(i["octave_losses"])
                  for i in styler.last_keyframe_infos.values()]

    ref = LnstColor(sc, GRID, vgg, style, SEED, device="cpu")
    frames, losses = ref.job(xs, dens, color, sched, STRIDE,
                             binned=route == "binned")

    assert len(got_losses) == len(losses) == 3
    for g, w in zip(got_losses, losses):
        torch.testing.assert_close(g, w, rtol=LOSS_RTOL, atol=0.0)
    assert sorted(got) == list(range(T))
    for t, want in enumerate(frames):
        for g, w, base, name in zip(got[t], want, (xs[t], dens, color),
                                    ("x", "dens", "color")):
            assert _gap(g, w, base) <= GAP, (t, name, _gap(g, w, base))
    # the job moved every attribute, colour included
    assert float((frames[-1][2] - color).abs().max()) > 0.05
    assert float((frames[-1][0] - xs[-1]).abs().max()) > 0.05


def test_the_reference_imports_neither_the_port_nor_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import benchmark.reference.lnst_color
        print(sorted({{m.split(".")[0] for m in sys.modules}}
                     & {{"nfs_tpu_torch", "nfs_tpu", "jax", "jaxlib"}}))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
