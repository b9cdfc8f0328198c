"""Stylization CLI (counterpart of ``nfs_tpu/cli/stylize.py``).

Usage:
  python -m nfs_tpu_torch.cli.stylize --tag smoke_fire \\
      --data_dir data/smoke3d --target_frame 70 \\
      --style_target data/styles/fire.png --w_style 1.0 \\
      --octave_n 3 --iter 30 --n_views 9 --transmit 0.01

  python -m nfs_tpu_torch.cli.stylize --mode particle --tag liquid \\
      --data_dir data/liquid3d --num_frames 40 --grid_shape 96 64 96 \\
      --opt_density --keyframe_stride 10 --style_target style.npy

  torchrun --standalone --nproc_per_node 4 -m nfs_tpu_torch.cli.stylize \\
      --parallel --mesh_frames 2 --mesh_views 2 --num_frames 16 \\
      --window 1 --data_dir data/smoke3d --style_target style.npy

The flags are the JAX CLI's flags plus ``--device`` (default ``cuda``; a
missing GPU is an error). Grid mode runs a single 2D or 3D frame, or a
sequence (``--num_frames`` > 1 or ``--window`` > 0) on the streaming path
or, with ``--fused F`` > 1, in chunks of F frames; ``--transfer_fn``
colours the renders and ``--train_transfer`` trains its control points
with the density. ``--parallel`` optimizes all frames of a grid sequence
jointly (``parallel.ParallelSequenceStyler``) on a (``--mesh_frames``,
``--mesh_views``) mesh of ranks, by default ``mesh_shape_for`` of the
world size: one process on one device, or one process per GPU under
``torchrun`` (NCCL; gloo with ``--device cpu``), every rank passing
``--device cuda``; rank 0 writes the frames and previews.
Particle mode (LNST) reads ``p_%04d.npz`` frames (2D or 3D), optimizes
keyframes, with ``--opt_color`` the particles' colours too, and
interpolates between them (``ParticleStyler.stylize_keyframes``, each
keyframe warm-started from the one before); with ``--parallel`` all
keyframes are optimized jointly and independently
(``parallel.ParallelKeyframeStyler``) on ``--mesh_frames`` ranks, by
default the world's, as in the grid path.
Outputs land in ``<log_dir>/<tag>/``: stylized ``d_%04d.npz`` or
``p_%04d.npz`` frames, the carry ``param_%04d.npz`` of grid sequence
frames (every frame when streaming, each chunk's last frame when fused),
the trained transfer function ``tf_%04d.npz`` (``nodes``), preview
images, a ``metrics.jsonl`` log and, for grid sequences, a
``manifest.json`` of finished frames. A rerun of a grid sequence skips
the frames the manifest holds and continues the warm-start chain from
the last saved param (at most F-1 finished frames are stylized again
when fused). With ``--checkpoint_in_frame`` every grid frame writes
{param, Adam state} to ``inframe_ckpt.npz`` after each ``log_every``
iterations, and a rerun resumes the interrupted frame there with the
bits of an uninterrupted run (such a frame runs with cuDNN's
deterministic convolutions); the file is deleted when the frame
completes.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nfs_tpu_torch.core.config import (
    DataConfig, LossConfig, OptimConfig, ParallelConfig, ParticleConfig,
    RenderConfig, StyleConfig)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Neural flow stylization on PyTorch (TNST/LNST)")
    # run / data (reference --tag, --data_dir, ...)
    p.add_argument("--tag", default="run")
    p.add_argument("--data_dir", default="data/smoke")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--d_path", default="d_%04d.npz")
    p.add_argument("--v_path", default="v_%04d.npz")
    p.add_argument("--p_path", default="p_%04d.npz")
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
    p.add_argument("--train_transfer", action="store_true",
                   help="jointly optimize the transfer-function control "
                        "points with the density (grid mode, single "
                        "frames and sequences; requires --transfer_fn)")
    p.add_argument("--transfer_fn", default=None,
                   help="density->RGB transfer function for colored "
                        "rendering: builtin colormap (fire, ice, viridis,"
                        " gray), gradient-image path or trained-nodes "
                        ".npz")
    p.add_argument("--tf_max_density", type=float, default=2.0)
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
    # particle (LNST)
    p.add_argument("--opt_position", action="store_true", default=True)
    p.add_argument("--no_opt_position", dest="opt_position",
                   action="store_false")
    p.add_argument("--opt_density", action="store_true")
    p.add_argument("--opt_color", action="store_true",
                   help="optimize per-particle colours (particle mode)")
    p.add_argument("--keyframe_stride", type=int, default=10)
    p.add_argument("--max_log_dens", type=float, default=None,
                   help="bound the per-particle density factor to "
                        "exp(+-x) (tanh-limited log scale)")
    p.add_argument("--grid_shape", type=int, nargs="+", default=None,
                   help="splat grid shape for particle mode")
    # sequence dispatch / parallel
    p.add_argument("--fused", type=int, default=0,
                   help="frames per chunk for grid sequences (0 = "
                        "streaming; F>1 runs chunks of F frames and saves "
                        "the carry param at each chunk's end)")
    p.add_argument("--checkpoint_in_frame", action="store_true",
                   help="checkpoint {param, Adam state} every log_every "
                        "iterations inside each frame; a restarted run "
                        "resumes the interrupted frame mid-octave and "
                        "bit-matches an uninterrupted run")
    p.add_argument("--parallel", action="store_true",
                   help="jointly optimize all frames on a (frames, views) "
                        "device mesh (ParallelSequenceStyler); in particle "
                        "mode all keyframes, independently "
                        "(ParallelKeyframeStyler)")
    p.add_argument("--mesh_frames", type=int, default=None)
    p.add_argument("--mesh_views", type=int, default=None)
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
            d_path=args.d_path, v_path=args.v_path, p_path=args.p_path,
            num_frames=args.num_frames, target_frame=args.target_frame,
            frame_stride=args.frame_stride),
        render=RenderConfig(
            transmit=args.transmit, render_size=tuple(args.render_size),
            n_views=args.n_views, theta0=args.theta0, theta1=args.theta1,
            phi0=args.phi0, phi1=args.phi1, sample_type=args.sample_type,
            gamma=args.gamma, transfer_fn=args.transfer_fn,
            tf_max_density=args.tf_max_density,
            fixed_view_schedule=args.fixed_view_schedule,
            train_transfer=args.train_transfer),
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
        particle=ParticleConfig(
            optimize_position=args.opt_position,
            optimize_density=args.opt_density,
            optimize_color=args.opt_color,
            keyframe_stride=args.keyframe_stride,
            max_log_dens=args.max_log_dens),
        parallel=ParallelConfig(
            frames=args.mesh_frames or 1,
            views=args.mesh_views or 1,
            halo=args.window),
        seed=args.seed,
    )


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)

    import torch

    from nfs_tpu_torch.io.image import save_image
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.render.raymarch import render2d, render_volume
    from nfs_tpu_torch.render.transfer import resolve_transfer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")

    out_dir = os.path.join(cfg.data.log_dir, cfg.data.tag)
    os.makedirs(out_dir, exist_ok=True)
    store = FrameStore(cfg.data.data_dir, cfg.data.d_path, cfg.data.v_path,
                       cfg.data.p_path, manta_order=args.manta_order)
    out_store = FrameStore(out_dir, cfg.data.d_path, cfg.data.v_path,
                           cfg.data.p_path)
    metrics_path = os.path.join(out_dir, "metrics.jsonl")

    def log_metric(**kw):
        with open(metrics_path, "a") as f:
            f.write(json.dumps(kw) + "\n")

    tf = resolve_transfer(cfg.render.transfer_fn)
    tf = None if tf is None else torch.as_tensor(tf, device=device)

    def preview(frame, d_star):
        rc = cfg.render
        with torch.no_grad():
            if d_star.ndim == 2:
                img = render2d(d_star, out_size=rc.render_size, tf_nodes=tf,
                               tf_max=rc.tf_max_density)
            else:
                img = render_volume(d_star, 0.0, 0.0, transmit=rc.transmit,
                                    out_size=rc.render_size, tf_nodes=tf,
                                    tf_max=rc.tf_max_density)
        save_image(os.path.join(out_dir, f"preview_{frame:04d}.png"),
                   img.cpu().numpy())

    frames = list(range(cfg.data.target_frame,
                        cfg.data.target_frame + cfg.data.num_frames,
                        cfg.data.frame_stride))
    if args.mode == "particle":
        _run_particles(cfg, args, store, out_store, frames, preview,
                       log_metric, device)
        print(f"done -> {out_dir}")
        return

    from nfs_tpu_torch.styler.grid import GridStyler

    if args.parallel and len(frames) > 1:
        _run_parallel(cfg, store, out_store, frames, preview, log_metric,
                      device)
        return
    styler = GridStyler(cfg, device=device)
    if cfg.optim.window > 0 or len(frames) > 1:
        _run_sequence(cfg, args, styler, store, out_store, out_dir, frames,
                      preview, log_metric)
    else:
        t = frames[0]
        d = store.load_density(t)
        t0 = time.time()
        d_star, _, info = styler.stylize_frame(
            d, checkpoint_path=_checkpoint_path(args, out_dir))
        d_np = d_star.cpu().numpy()
        dt = time.time() - t0
        out_store.save_density(t, d_np)
        if "tf_nodes" in info:   # the trained transfer function
            np.savez(os.path.join(out_dir, f"tf_{t:04d}.npz"),
                     nodes=info["tf_nodes"].cpu().numpy())
        preview(t, d_star)
        # a frame resumed at an octave's end ran no iteration there
        losses = [float(l[-1]) for l in info["octave_losses"] if len(l)]
        n_iters = cfg.optim.iters * cfg.optim.octave_n
        log_metric(frame=t, wall_s=dt, iters=n_iters,
                   iters_per_sec=n_iters / dt, final_losses=losses,
                   device=str(device))
        print(f"[frame {t}] {dt:.1f}s ({n_iters / dt:.2f} iters/s on "
              f"{device}) losses={losses}")
    print(f"done -> {out_dir}")


def _run_parallel(cfg, store, out_store, frames, preview, log_metric,
                  device) -> None:
    """All frames jointly on a (frames, views) mesh of ranks: every rank
    runs the engine on the whole sequence; rank 0 writes each frame and
    its preview and logs the run, while the others wait at a barrier, so
    that no rank exits before the files exist."""
    import torch.distributed as dist

    from nfs_tpu_torch.parallel import (
        ParallelSequenceStyler, initialize_multihost, make_mesh)
    from nfs_tpu_torch.parallel.mesh import mesh_shape_for
    from nfs_tpu_torch.styler.grid import GridStyler

    joined = not dist.is_initialized()
    world = initialize_multihost(device)
    joined = joined and dist.is_initialized()
    pc = cfg.parallel
    mesh = (make_mesh(pc.frames, pc.views) if pc.frames > 1 or pc.views > 1
            else make_mesh(*mesh_shape_for(world)))
    engine = ParallelSequenceStyler(GridStyler(cfg, device=device), mesh)
    densities = np.stack([store.load_density(t) for t in frames])
    vels = None
    if os.path.exists(os.path.join(cfg.data.data_dir,
                                   cfg.data.v_path % frames[0])):
        vels = np.stack([store.load_velocity(t) for t in frames])
    t0 = time.time()
    d_star, _, info = engine.stylize(densities, vels)
    wall = time.time() - t0
    if mesh.rank == 0:
        for i, t in enumerate(frames):
            out_store.save_density(t, d_star[i].cpu().numpy())
            preview(t, d_star[i])
        log_metric(frames=len(frames), wall_s=wall, mesh=dict(mesh.shape),
                   final_loss=float(info["octave_losses"][-1][-1]))
        print(f"[parallel] {len(frames)} frames in {wall:.1f}s on mesh "
              f"{dict(mesh.shape)} of {world} rank(s)")
        print(f"done -> {out_store.data_dir}")
    if mesh.distributed:
        dist.barrier()
    if joined:
        dist.destroy_process_group()


def _checkpoint_path(args, out_dir):
    """The in-frame checkpoint of --checkpoint_in_frame, else None."""
    return (os.path.join(out_dir, "inframe_ckpt.npz")
            if args.checkpoint_in_frame else None)


def _save_param(out_dir: str, t: int, param) -> None:
    """The carry param of frame t; a --train_transfer carry is saved per
    leaf (``param/field``, ``param/tf``) with its clipped nodes in
    ``tf_%04d.npz``, as the JAX CLI writes them."""
    path = os.path.join(out_dir, f"param_{t:04d}.npz")
    if isinstance(param, dict):
        np.savez(path, **{"param/" + k: v.cpu().numpy()
                          for k, v in param.items()})
        np.savez(os.path.join(out_dir, f"tf_{t:04d}.npz"),
                 nodes=np.clip(param["tf"].cpu().numpy(), 0, 1))
    else:
        np.savez(path, param=param.cpu().numpy())


def _load_param(path: str):
    with np.load(path) as z:
        if "param" in z.files:
            return z["param"]
        return {k[len("param/"):]: z[k] for k in z.files
                if k.startswith("param/")}


def _run_sequence(cfg, args, styler, store, out_store, out_dir, frames,
                  preview, log_metric) -> None:
    """A grid sequence with frame-granular resume: frames the manifest
    marks as done are skipped, and the recursive warm-start chain
    continues from the last completed frame's saved param, transported by
    that frame's velocity."""
    from nfs_tpu_torch.io.checkpoint import SequenceManifest

    manifest = SequenceManifest(os.path.join(out_dir, "manifest.json"))
    start = 0
    while start < len(frames) and manifest.done(frames[start]):
        start += 1
    # the fused path saves the carry param only at chunk ends (every
    # frame's with --checkpoint_in_frame): step back to the last frame
    # whose param was saved, so the chain stays exact
    if args.fused and args.fused > 1:
        while start > 0 and not os.path.exists(os.path.join(
                out_dir, f"param_{frames[start - 1]:04d}.npz")):
            start -= 1
    todo = frames[start:]
    if not todo:
        print("all frames already stylized (manifest)")
        return
    densities = [store.load_density(t) for t in todo]
    vels = None
    if os.path.exists(os.path.join(cfg.data.data_dir,
                                   cfg.data.v_path % todo[0])):
        vels = [store.load_velocity(t) for t in todo]
    init_param = prev_velocity = None
    if start > 0:
        prev_t = frames[start - 1]
        ppath = os.path.join(out_dir, f"param_{prev_t:04d}.npz")
        if os.path.exists(ppath):
            init_param = _load_param(ppath)
            vpath = os.path.join(cfg.data.data_dir, cfg.data.v_path % prev_t)
            if os.path.exists(vpath):
                prev_velocity = store.load_velocity(prev_t)
    t0 = time.time()
    for i, d_star, param in styler.stylize_sequence(
            densities, vels, fused=args.fused,
            checkpoint_path=_checkpoint_path(args, out_dir),
            init_param=init_param, prev_velocity=prev_velocity,
            frame_offset=start):
        t = todo[i]
        out_store.save_density(t, d_star.cpu().numpy())
        if param is not None:
            _save_param(out_dir, t, param)
        preview(t, d_star)
        dt = time.time() - t0
        manifest.mark(t, os.path.join(out_dir, cfg.data.d_path % t),
                      wall_s=round(dt, 3))
        log_metric(frame=t, wall_s=dt,
                   iters=cfg.optim.iters * cfg.optim.octave_n)
        print(f"[frame {t}] {dt:.1f}s")
        t0 = time.time()


def _run_particles(cfg, args, store, out_store, frames, preview, log_metric,
                   device) -> None:
    """LNST: keyframe optimization + attribute interpolation over the
    particle frames, one ``p_%04d.npz`` and one preview per frame. With
    ``--parallel`` and more than one frame the keyframes are optimized
    jointly and independently (``ParallelKeyframeStyler``) on
    ``make_mesh(--mesh_frames)``, or on the default mesh of the world's
    ranks; every rank runs the engine, rank 0 writes and the others wait
    at a barrier."""
    import torch
    import torch.distributed as dist

    from nfs_tpu_torch.core.pytrees import ParticleSet
    from nfs_tpu_torch.styler.particle import ParticleStyler

    parallel = args.parallel and len(frames) > 1
    joined = False
    if parallel:
        from nfs_tpu_torch.parallel import initialize_multihost

        joined = not dist.is_initialized()
        initialize_multihost(device)
        joined = joined and dist.is_initialized()

    psets = []
    for t in frames:
        raw = store.load_particles(t)
        psets.append(ParticleSet(x=raw["x"], dens=raw.get("dens"),
                                 color=raw.get("color")))
    ndim = int(psets[0].x.shape[-1])
    grid_shape = (tuple(args.grid_shape) if args.grid_shape
                  else (128,) * ndim)
    styler = ParticleStyler(cfg, grid_shape=grid_shape, device=device)
    engine, mesh = styler, None
    if parallel:
        from nfs_tpu_torch.parallel import ParallelKeyframeStyler, make_mesh

        pc = cfg.parallel
        engine = ParallelKeyframeStyler(
            styler, make_mesh(pc.frames) if pc.frames > 1 else None)
        mesh = engine.mesh
    write = mesh is None or mesh.rank == 0
    t0 = time.time()
    for i, styled in engine.stylize_keyframes(psets):
        if not write:
            continue
        t = frames[i]
        out_store.save_particles(
            t, x=styled.x.cpu().numpy(), dens=styled.dens.cpu().numpy(),
            **({"color": np.asarray(torch.as_tensor(styled.color).cpu())}
               if styled.color is not None else {}))
        preview(t, styler.rasterize(styled))
        kf_info = engine.last_keyframe_infos.get(i, {})
        log_metric(frame=t, wall_s=time.time() - t0,
                   splat_overflow=kf_info.get("octave_overflow"),
                   **({"mesh": dict(mesh.shape)} if mesh is not None
                      else {}))
        t0 = time.time()
    if mesh is not None:
        if write:
            print(f"[parallel] {len(frames)} particle frames, keyframes "
                  f"{sorted(engine.last_keyframe_infos)} on mesh "
                  f"{dict(mesh.shape)} of {mesh.world} rank(s)")
        if mesh.distributed:
            dist.barrier()
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
