"""Render stylized frames to images or a video (counterpart of
``nfs_tpu/cli/render.py``): load frames, render one fixed view, write a
PNG sequence and optionally a video.

    python -m nfs_tpu_torch.cli.render --data_dir log/smoke_fire \\
        --num_frames 200 --out log/smoke_fire/render --video out.mp4 \\
        --theta 0 --phi 0 --transmit 0.01

Grid mode renders ``d_%04d.npz`` densities (2D with ``render2d``, 3D with
``render_volume``); particle mode splats ``p_%04d.npz`` particles onto
``--grid_shape`` first. ``--transfer_fn`` colours the render. Runs on
``--device`` (default ``cuda``; a missing GPU is an error). Without PIL
an image is written as ``<name>.png.npy``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="render stylized frames")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--d_path", default="d_%04d.npz")
    p.add_argument("--p_path", default="p_%04d.npz")
    p.add_argument("--mode", choices=["grid", "particle"], default="grid")
    p.add_argument("--grid_shape", type=int, nargs="+", default=None,
                   help="splat grid for particle mode")
    p.add_argument("--target_frame", type=int, default=0)
    p.add_argument("--num_frames", type=int, default=1)
    p.add_argument("--frame_stride", type=int, default=1)
    p.add_argument("--out", default=None,
                   help="output dir (default <data_dir>/render)")
    p.add_argument("--video", default=None,
                   help="also write a video file (imageio/ffmpeg if "
                        "available, else PNG sequence)")
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--render_size", type=int, nargs=2, default=(512, 512))
    p.add_argument("--theta", type=float, default=0.0, help="degrees")
    p.add_argument("--phi", type=float, default=0.0, help="degrees")
    p.add_argument("--transmit", type=float, default=0.01)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--transfer_fn", default=None,
                   help="density->RGB transfer function: builtin colormap"
                        " (fire, ice, viridis, gray) or gradient-image "
                        "path; default grayscale")
    p.add_argument("--tf_max_density", type=float, default=2.0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda); a missing GPU is an "
                        "error, there is no CPU fallback")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from nfs_tpu_torch.io.image import save_image, save_video
    from nfs_tpu_torch.io.npz import FrameStore
    from nfs_tpu_torch.ops.splat import splat
    from nfs_tpu_torch.render.raymarch import render2d, render_volume
    from nfs_tpu_torch.render.transfer import resolve_transfer

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")

    tf_nodes = resolve_transfer(args.transfer_fn)
    if tf_nodes is not None:
        tf_nodes = torch.as_tensor(tf_nodes, dtype=torch.float32,
                                   device=device)

    out_dir = args.out or os.path.join(args.data_dir, "render")
    os.makedirs(out_dir, exist_ok=True)
    store = FrameStore(args.data_dir, d_path=args.d_path,
                       p_path=args.p_path)
    theta = np.float32(np.radians(args.theta))
    phi = np.float32(np.radians(args.phi))

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    frames = []
    for t in range(args.target_frame,
                   args.target_frame + args.num_frames,
                   args.frame_stride):
        with torch.no_grad():
            if args.mode == "grid":
                d = on_device(store.load_density(t))
            else:
                raw = store.load_particles(t)
                x = on_device(raw["x"])
                shape = tuple(args.grid_shape or (128,) * x.shape[-1])
                dens = raw.get("dens")
                dens = (on_device(dens) if dens is not None else
                        torch.ones(x.shape[0], dtype=torch.float32,
                                   device=device))
                d = splat(x, dens, shape)
            if d.ndim == 2:
                img = render2d(d, out_size=tuple(args.render_size),
                               gamma=args.gamma, tf_nodes=tf_nodes,
                               tf_max=args.tf_max_density)
            else:
                img = render_volume(d, theta, phi, transmit=args.transmit,
                                    out_size=tuple(args.render_size),
                                    gamma=args.gamma, tf_nodes=tf_nodes,
                                    tf_max=args.tf_max_density)
        img = img.cpu().numpy()
        save_image(os.path.join(out_dir, f"frame_{t:04d}.png"), img)
        frames.append(img)
        print(f"rendered frame {t}")

    if args.video:
        save_video(os.path.join(out_dir, args.video), frames, fps=args.fps)
    print(f"done -> {out_dir}")


if __name__ == "__main__":
    main()
