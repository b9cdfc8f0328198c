"""Typed configuration for the stylization pipeline.

A copy of ``nfs_tpu/core/config.py`` that imports nothing of
``nfs_tpu`` (whose package import pulls in JAX): the same dataclasses,
fields and defaults, so one configuration drives both packages. Options
the port does not implement yet raise ``NotImplementedError`` where they
are used, naming their ROADMAP item.

All configs are frozen (hashable).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DataConfig:
    """Frame data layout (reference flags: --data_dir, --d_path, --v_path,
    --p_path, --num_frames, --target_frame, --frame_stride)."""

    data_dir: str = "data/smoke"
    log_dir: str = "log"
    tag: str = "run"
    # printf-style per-frame file patterns relative to data_dir
    d_path: str = "d_%04d.npz"      # density grids
    v_path: str = "v_%04d.npz"      # simulation velocity grids
    p_path: str = "p_%04d.npz"      # particle positions (+ attrs)
    num_frames: int = 1
    target_frame: int = 0
    frame_stride: int = 1


@dataclass(frozen=True)
class RenderConfig:
    """Differentiable renderer + camera sampling knobs (reference flags:
    --transmit, --render_size, --n_views, --phi0/1, --theta0/1,
    --sample_type; TNST §5)."""

    # Beer-Lambert absorption coefficient per unit density per cell.
    transmit: float = 0.01
    # Output image (H, W); for 2D grids the grid itself is the image.
    render_size: Tuple[int, int] = (256, 256)
    n_views: int = 9
    # View-angle rectangle, degrees. theta = azimuth about the vertical (y)
    # axis, phi = elevation. Defaults match a frontal fan of views.
    theta0: float = -10.0
    theta1: float = 10.0
    phi0: float = -5.0
    phi1: float = 5.0
    # 'poisson' (Bridson, host-precomputed pool) | 'stratified'
    # | 'uniform'
    sample_type: str = "poisson"
    # number of precomputed Poisson-disk view sets cycled during optimization
    view_pool: int = 64
    # jointly OPTIMIZE the transfer function's control points with the
    # density field (the hat-basis expansion in render/transfer.py is
    # differentiable in its nodes): the styler's param becomes the
    # pytree {'field', 'tf'} and the trained nodes come back in
    # info['tf_nodes']. Single-frame path only (sequence paths hold the
    # TF fixed); requires transfer_fn to seed the nodes.
    train_transfer: bool = False
    # use the SAME per-iteration view schedule for every frame of a
    # sequence (per-frame PRNG keys stop folding in the frame index).
    # Each frame still cycles the full view pool across iterations, but
    # frame t and frame t+1 see identical view draws at iteration i —
    # removing view-sampling jitter from the frame-to-frame stylization
    # drift (temporal-coherence lever; see bench/quality.py).
    fixed_view_schedule: bool = False
    # post-render mapping before the CNN
    gamma: float = 1.0
    # view-rotation algorithm: 'shear' (three-shear decomposition as
    # batched banded matmuls) | 'shear_bf16' (the same with bf16
    # operands) | 'gather' (exact trilinear resample)
    rotation: str = "shear"
    # scale the render resolution down with coarse octaves (true multi-
    # scale: a 2x-coarser volume is rendered/stylized at 2x-coarser
    # images, cutting VGG cost at early octaves). Disabled automatically
    # when a content target is set (its features are size-bound).
    scale_with_octave: bool = True
    # floor for the scaled render size
    min_render_size: int = 64
    # density -> RGB transfer function for colored smoke rendering:
    # builtin colormap name ('fire', 'ice', 'viridis', 'gray'), a path to
    # a gradient image, or None = grayscale tiled to RGB (the reference's
    # behavior). Widens the grid path to color styles — the colored
    # renders feed the same VGG Gram losses (nfs_tpu/render/transfer.py).
    transfer_fn: Optional[str] = None
    # density mapped to the TF's last control point (higher clamps)
    tf_max_density: float = 2.0


@dataclass(frozen=True)
class LossConfig:
    """Loss network and objective knobs (reference flags: --style_target,
    --content_target, --content_layer, --content_channel, --style_layer,
    --w_style, --w_content, per-layer style weights; TNST §4)."""

    # Path to style image. None => semantic-only objective.
    style_target: Optional[str] = None
    # Gram-loss layers of VGG-19 with per-layer weights.
    style_layers: Tuple[str, ...] = (
        "relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1",
    )
    style_layer_weights: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0, 1.0)
    w_style: float = 1.0
    # Content / semantic objective (DeepDream-style): maximize the mean
    # activation of `content_channel` in `content_layer`. If
    # content_channel is None and content_target is set, a feature-matching
    # content loss is used instead.
    content_layer: Optional[str] = None
    content_channel: Optional[int] = None
    content_target: Optional[str] = None
    w_content: float = 0.0
    # Total-variation regularizer on the optimized field.
    w_tv: float = 0.0
    # VGG-19 weights file (.npz of params); None => deterministic random
    # init (features are still a valid multi-scale image prior; see
    # nfs_tpu/features/vgg.py docstring and SURVEY.md §7 step 3 risk note).
    vgg_weights: Optional[str] = None
    pool: str = "avg"  # 'avg' | 'max' pooling inside VGG
    # VGG compute dtype: 'bfloat16' (Gram accumulation stays f32);
    # 'float32' for numeric tests.
    features_dtype: str = "float32"
    # rematerialize per-view render+VGG in the backward pass (views
    # evaluated one at a time instead of one batch): cuts peak activation
    # memory at the cost of recompute. Not ported yet.
    remat_views: bool = False


@dataclass(frozen=True)
class OptimConfig:
    """Octave Adam loop (reference flags: --octave_n, --octave_scale,
    --iter, --lr; TNST §4, DeepDream-style octaves)."""

    octave_n: int = 3
    octave_scale: float = 1.8
    iters: int = 30          # Adam iterations per octave
    lr: float = 0.01
    # schedule for WARM-STARTED sequence frames (recursive init from the
    # advected previous solution, TNST §6): they re-converge in far
    # fewer, smaller steps than a cold frame, and every extra step is
    # re-optimization DRIFT — the dominant temporal-incoherence term.
    # None = use iters/lr for every frame (reference behavior).
    warm_iters: Optional[int] = None
    warm_lr: Optional[float] = None
    # 'density'  => optimize an additive density perturbation (d* = d + dd)
    # 'velocity' => transport parameterization, d* = advect(d, v_hat)
    #               (TNST §4.2)
    parameterization: str = "density"
    # temporal window half-width W for sequence stylization (TNST §6);
    # 0 => per-frame independent
    window: int = 0
    # Gaussian sigma (in frames) for window blend weights
    window_sigma: float = 1.0
    # log/callback cadence: iterations between host callbacks
    log_every: int = 10
    # bound (cells) on per-step advection displacement inside the loss
    # pipeline. Non-None switches advection to the bounded-displacement
    # window formulation (ops/advect.py); displacements are clamped to
    # +-max_disp (a CFL-style regularizer). None (the exact gather path)
    # is not ported yet.
    max_disp: Optional[float] = 2.0
    # advection scheme for the recursive warm-start transport of the
    # OPTIMIZATION PARAM between frames (TNST §6): 'semi' = one
    # semi-Lagrangian pass; 'maccormack' = BFECC with min-max limiting —
    # second-order, so the inherited stylization pattern diffuses less
    # per frame (temporal-coherence lever, VERDICT r2 #5). Costs ~2 extra
    # window passes per FRAME (not per iteration) — negligible.
    param_advect: str = "maccormack"
    # backend for the bounded-displacement advects INSIDE the loss
    # (window transport states, velocity-parameterization apply):
    # 'auto' = the advection kernels K1-K3 (ops/advect_kernels.py) for
    # 3D scalar fields, the window-tap sum elsewhere; 'pallas' forces the
    # kernels (the name is the JAX package's); 'xla' pins the window-tap
    # sum.
    advect_impl: str = "auto"
    # tighter bound for the OPTIMIZED stylization velocity field v_hat
    # (TNST §4.2): its displacements are small perturbations, and the
    # window tap count scales with (2*ceil(bound)+3)^d — bound 1 uses
    # 125 taps vs 343 for bound 2 in 3D.
    param_max_disp: Optional[float] = 1.0
    # Adam moments
    b1: float = 0.9
    b2: float = 0.999
    # frames per dispatch for stylize_sequence: 0/1 = streaming (one
    # frame at a time, per-frame observability); F>1 = fused multi-frame
    # dispatch, not ported yet
    fused_frames: int = 0


@dataclass(frozen=True)
class ParticleConfig:
    """LNST per-particle parameterization (LNST §4): which attributes are
    optimized, splat kernel support, keyframe cadence (LNST §5)."""

    optimize_position: bool = True
    optimize_density: bool = False
    optimize_color: bool = False
    # splat kernel: 'bspline' quadratic (3^d support) | 'linear' (2^d)
    kernel: str = "bspline"
    # particle radius scale in cells (kernel dilation)
    support: float = 1.0
    # keyframe stride; attributes are interpolated between keyframes
    keyframe_stride: int = 10
    # clamp on position offsets (cells)
    max_offset: float = 4.0
    # optional bound on the per-particle density factor: exp(ddens)
    # becomes exp(+-max_log_dens * tanh(ddens / max_log_dens)). None =
    # unbounded (reference behavior) — but an unbounded exp() under a
    # hot Adam lr can blow densities up by orders of magnitude (observed
    # exp(9) at lr 0.12 x 160 iters); 2.0 bounds the factor to ~[0.14, 7.4]
    max_log_dens: Optional[float] = None
    # splat implementation (particle path, not ported yet): 'auto' |
    # 'binned' = dense (cells, K) shift-window | 'binned_pallas' = binned
    # layout with the window kernels K4/K5 | 'flat' = one flat scatter
    splat_impl: str = "auto"
    # iterations between re-binnings (position drift between rebins
    # truncates O(drift^2) kernel mass at the bin-support edge; drift
    # per chunk is bounded by ~lr*rebin_every cells << 1 at default lr,
    # and the +1 capacity headroom plus the overflow warning guard the
    # crowding case). Each rebin pays an O(N log N) sort plus ~12 row
    # scatter/gathers permuting params+Adam state.
    rebin_every: int = 20
    # coarse-octave strategy (octaves below full splat resolution):
    # 'grid' — optimize a multiplicative log-density FIELD over the
    # once-splatted octave density (TNST-priced iterations: the O(N)
    # per-iteration particle splat leaves the coarse path entirely),
    # then fold the field into per-particle ddens with one trilinear
    # sample at particle positions. The particle splat cost is
    # ~constant across octaves (cells x K ~ N), so 'particle' coarse
    # octaves cost nearly as much as the finest — 'grid' restores the
    # multi-scale discount TNST enjoys. Requires optimize_density
    # (ddens receives the transfer); otherwise octaves fall back to
    # 'particle'. 'particle' = per-particle attrs at every octave
    # (exact LNST §4 multi-scale).
    coarse_mode: str = "grid"
    # fall back to 'flat' when padded_cells * K exceeds this (memory cap)
    max_bin_slots: int = 64_000_000
    # chunk-state layout for the binned path: 'auto' = the splat
    # kernels' shifted (K, Zp, Yb, Xb) layout when they are eligible
    # (3D + bspline + density-only attrs), flat slots otherwise |
    # 'slots' forces the flat layout
    binned_layout: str = "auto"
    # parked-fraction budget for bin capacity K: pick the smallest K
    # whose binning parks at most this fraction of particles (skipped
    # from the splat until the next rebin), instead of sizing K to the
    # single most crowded cell. Dense-bin cost (window pass + param/Adam
    # state) is LINEAR in K while the occupancy tail is ~exponential, so
    # the budget adapts automatically on clumped distributions
    # (parked(K) is measured, not assumed). Engages only when the budget rounds to >= 1 particle (tiny sets keep the exact
    # capacity + headroom); the overflow warning threshold becomes 4x
    # the budget (drift headroom) instead of zero. None = exact legacy
    # sizing.
    k_budget: Optional[float] = 0.001


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout (multi-device path, not ported yet).

    Axes: 'frames' shards independent frames / temporal windows (DP with
    ppermute halos), 'views' shards camera views of one frame (psum gradient
    reduction). See SURVEY.md §2 parallelism inventory.
    """

    frames: int = 1
    views: int = 1
    # halo depth (frames) exchanged between neighbor shards for window loss
    halo: int = 0


@dataclass(frozen=True)
class StyleConfig:
    """Top-level bundle passed to the stylers."""

    data: DataConfig = field(default_factory=DataConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    particle: ParticleConfig = field(default_factory=ParticleConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0

    def replace(self, **kw) -> "StyleConfig":
        return dataclasses.replace(self, **kw)


def _tuplify(v):
    """Lists arriving from JSON/YAML become tuples so frozen configs stay
    hashable (cache keys). Recursive: [[32, 32], [1.0]] -> ((32, 32), (1.0,))."""
    if isinstance(v, list):
        return tuple(_tuplify(x) for x in v)
    return v


def replace(cfg, **kw):
    """dataclasses.replace that tolerates nested dotted keys, e.g.
    ``replace(cfg, **{"optim.iters": 50})``, and normalizes list values
    to tuples (JSON has no tuples; an unhashable config breaks every
    cache-key use downstream)."""
    flat = {}
    nested = {}
    for k, v in kw.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
        else:
            flat[k] = _tuplify(v)
    for head, sub in nested.items():
        flat[head] = replace(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **flat)
