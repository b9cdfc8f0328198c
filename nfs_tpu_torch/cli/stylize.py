"""Stylization CLI, grid mode (counterpart of ``nfs_tpu/cli/stylize.py``).

Usage:
  python -m nfs_tpu_torch.cli.stylize --tag smoke_fire \\
      --data_dir data/smoke3d --target_frame 70 \\
      --style_target data/styles/fire.png --w_style 1.0 \\
      --octave_n 3 --iter 30 --n_views 9 --transmit 0.01

The flags are the JAX CLI's grid-mode flags plus ``--device`` (default
``cuda``; a missing GPU is an error); the particle, mesh and
transfer-function flags come with the ROADMAP slices that port them.
Grid mode runs a single frame, or a sequence (``--num_frames`` > 1 or
``--window`` > 0) on the streaming path. Outputs
land in ``<log_dir>/<tag>/``: stylized ``d_%04d.npz`` frames, the final
``param_%04d.npz`` of each sequence frame, preview images and a
``metrics.jsonl`` log. Not ported yet, and refused with the ROADMAP item
that holds them: ``--mode particle``, ``--parallel``, ``--fused`` > 1 and
``--checkpoint_in_frame``. A rerun stylizes the whole sequence again:
resuming from a manifest waits for ROADMAP queue 1, item 16.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nfs_tpu_torch.core.config import (
    DataConfig, LossConfig, OptimConfig, RenderConfig, StyleConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Neural flow stylization on PyTorch (TNST grid mode)")
    # run / data (reference --tag, --data_dir, ...)
    p.add_argument("--tag", default="run")
    p.add_argument("--data_dir", default="data/smoke")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--d_path", default="d_%04d.npz")
    p.add_argument("--v_path", default="v_%04d.npz")
    p.add_argument("--num_frames", type=int, default=1)
    p.add_argument("--target_frame", type=int, default=0)
    p.add_argument("--frame_stride", type=int, default=1)
    p.add_argument("--manta_order", action="store_true",
                   help="input arrays use mantaflow (x,y,z) channel order")
    # mode
    p.add_argument("--mode", choices=["grid", "particle"], default="grid",
                   help="grid=TNST (smoke), particle=LNST (liquid/smoke)")
    # octaves / optimization (reference --octave_n, --octave_scale, --iter,
    # --lr)
    p.add_argument("--octave_n", type=int, default=3)
    p.add_argument("--octave_scale", type=float, default=1.8)
    p.add_argument("--iter", type=int, default=30, dest="iters")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--warm_iter", type=int, default=None,
                   help="iterations per octave for warm-started sequence "
                        "frames (fewer steps = less temporal drift)")
    p.add_argument("--warm_lr", type=float, default=None,
                   help="Adam lr for warm-started sequence frames")
    p.add_argument("--parameterization", choices=["density", "velocity"],
                   default="density",
                   help="TNST §4.2: additive density vs transport (v-hat)")
    p.add_argument("--window", type=int, default=0,
                   help="temporal window half-width W (TNST §6)")
    p.add_argument("--window_sigma", type=float, default=1.0)
    # renderer (reference --transmit, --n_views, angle ranges,
    # --sample_type)
    p.add_argument("--transmit", type=float, default=0.01)
    p.add_argument("--render_size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--n_views", type=int, default=9)
    p.add_argument("--theta0", type=float, default=-10.0)
    p.add_argument("--theta1", type=float, default=10.0)
    p.add_argument("--phi0", type=float, default=-5.0)
    p.add_argument("--phi1", type=float, default=5.0)
    p.add_argument("--sample_type", choices=["poisson", "stratified"],
                   default="poisson")
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--fixed_view_schedule", action="store_true",
                   help="same per-iteration view draws for every frame "
                        "(temporal-coherence lever)")
    # loss (reference --style_target, --style_layer, --w_style,
    # --content_layer, --content_channel, --w_content)
    p.add_argument("--style_target", default=None,
                   help="style image path (Gram losses)")
    p.add_argument("--style_layer", default="relu1_1,relu2_1,relu3_1,"
                   "relu4_1,relu5_1")
    p.add_argument("--w_style_layer", default=None,
                   help="comma list of per-layer weights (default 1s)")
    p.add_argument("--w_style", type=float, default=1.0)
    p.add_argument("--content_target", default=None)
    p.add_argument("--content_layer", default=None)
    p.add_argument("--content_channel", type=int, default=None)
    p.add_argument("--w_content", type=float, default=0.0)
    p.add_argument("--w_tv", type=float, default=0.0)
    p.add_argument("--vgg_weights", default=None,
                   help=".npz of VGG-19 params (see scripts/"
                        "convert_vgg_weights.py); random init if absent")
    p.add_argument("--pool", choices=["avg", "max"], default="avg")
    # sequence dispatch / parallel
    p.add_argument("--fused", type=int, default=0,
                   help="frames per dispatch for grid sequences (0 = "
                        "streaming; F>1 is not ported yet)")
    p.add_argument("--checkpoint_in_frame", action="store_true",
                   help="checkpoint {param, Adam state} every log_every "
                        "iterations inside each frame; a restarted run "
                        "resumes the interrupted frame mid-octave and "
                        "bit-matches an uninterrupted run")
    p.add_argument("--parallel", action="store_true",
                   help="jointly optimize all frames on a (frames, views) "
                        "device mesh (ParallelSequenceStyler)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda); a missing GPU is an "
                        "error, there is no CPU fallback")
    return p


def config_from_args(args) -> StyleConfig:
    layers = tuple(s.strip() for s in args.style_layer.split(",") if s)
    if args.w_style_layer:
        lw = tuple(float(x) for x in args.w_style_layer.split(","))
    else:
        lw = tuple(1.0 for _ in layers)
    return StyleConfig(
        data=DataConfig(
            data_dir=args.data_dir, log_dir=args.log_dir, tag=args.tag,
            d_path=args.d_path, v_path=args.v_path,
            num_frames=args.num_frames, target_frame=args.target_frame,
            frame_stride=args.frame_stride),
        render=RenderConfig(
            transmit=args.transmit, render_size=tuple(args.render_size),
            n_views=args.n_views, theta0=args.theta0, theta1=args.theta1,
            phi0=args.phi0, phi1=args.phi1, sample_type=args.sample_type,
            gamma=args.gamma, fixed_view_schedule=args.fixed_view_schedule),
        loss=LossConfig(
            style_target=args.style_target, style_layers=layers,
            style_layer_weights=lw, w_style=args.w_style,
            content_layer=args.content_layer,
            content_channel=args.content_channel,
            content_target=args.content_target, w_content=args.w_content,
            w_tv=args.w_tv, vgg_weights=args.vgg_weights, pool=args.pool),
        optim=OptimConfig(
            octave_n=args.octave_n, octave_scale=args.octave_scale,
            iters=args.iters, lr=args.lr,
            warm_iters=args.warm_iter, warm_lr=args.warm_lr,
            parameterization=args.parameterization, window=args.window,
            window_sigma=args.window_sigma),
        seed=args.seed,
    )


def _refuse_unported(args) -> None:
    refused = [
        (args.mode == "particle", "--mode particle (LNST)", "item 19"),
        (args.parallel, "--parallel", "item 21"),
        (args.fused and args.fused > 1, "--fused > 1", "item 13"),
        (args.checkpoint_in_frame, "--checkpoint_in_frame", "item 16"),
    ]
    for hit, what, item in refused:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to nfs_tpu_torch yet: ROADMAP queue "
                f"1, {item}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    cfg = config_from_args(args)

    import torch

    from nfs_tpu_torch.io.image import save_image
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.render.raymarch import render_volume
    from nfs_tpu_torch.styler.grid import GridStyler

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")

    out_dir = os.path.join(cfg.data.log_dir, cfg.data.tag)
    os.makedirs(out_dir, exist_ok=True)
    store = FrameStore(cfg.data.data_dir, cfg.data.d_path, cfg.data.v_path,
                       manta_order=args.manta_order)
    out_store = FrameStore(out_dir, cfg.data.d_path, cfg.data.v_path)
    metrics_path = os.path.join(out_dir, "metrics.jsonl")

    def log_metric(**kw):
        with open(metrics_path, "a") as f:
            f.write(json.dumps(kw) + "\n")

    def preview(frame, d_star):
        with torch.no_grad():
            img = render_volume(d_star, 0.0, 0.0,
                                transmit=cfg.render.transmit,
                                out_size=cfg.render.render_size)
        save_image(os.path.join(out_dir, f"preview_{frame:04d}.png"),
                   img.cpu().numpy())

    frames = list(range(cfg.data.target_frame,
                        cfg.data.target_frame + cfg.data.num_frames,
                        cfg.data.frame_stride))
    styler = GridStyler(cfg, device=device)
    if cfg.optim.window > 0 or len(frames) > 1:
        densities = [store.load_density(t) for t in frames]
        vels = None
        if os.path.exists(os.path.join(cfg.data.data_dir,
                                       cfg.data.v_path % frames[0])):
            vels = [store.load_velocity(t) for t in frames]
        t0 = time.time()
        for i, d_star, param in styler.stylize_sequence(
                densities, vels, fused=args.fused):
            t = frames[i]
            out_store.save_density(t, d_star.cpu().numpy())
            np.savez(os.path.join(out_dir, f"param_{t:04d}.npz"),
                     param=param.cpu().numpy())
            preview(t, d_star)
            dt = time.time() - t0
            log_metric(frame=t, wall_s=dt,
                       iters=cfg.optim.iters * cfg.optim.octave_n)
            print(f"[frame {t}] {dt:.1f}s")
            t0 = time.time()
    else:
        t = frames[0]
        d = store.load_density(t)
        t0 = time.time()
        d_star, _, info = styler.stylize_frame(d)
        d_np = d_star.cpu().numpy()
        dt = time.time() - t0
        out_store.save_density(t, d_np)
        preview(t, d_star)
        losses = [float(l[-1]) for l in info["octave_losses"]]
        n_iters = cfg.optim.iters * cfg.optim.octave_n
        log_metric(frame=t, wall_s=dt, iters=n_iters,
                   iters_per_sec=n_iters / dt, final_losses=losses,
                   device=str(device))
        print(f"[frame {t}] {dt:.1f}s ({n_iters / dt:.2f} iters/s on "
              f"{device}) losses={losses}")
    print(f"done -> {out_dir}")


if __name__ == "__main__":
    main()
