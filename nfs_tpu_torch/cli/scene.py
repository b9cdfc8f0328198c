"""Scene / data-generation CLI (counterpart of ``nfs_tpu/cli/scene.py``):
the port's smoke and FLIP solvers write the per-frame ``.npz`` layout the
stylizer reads (``d_%04d.npz`` + ``v_%04d.npz``, or ``p_%04d.npz``).

Usage:
  python -m nfs_tpu_torch.cli.scene --scene smoke2d --out data/smoke2d \\
      --res 256 192 --frames 120
  python -m nfs_tpu_torch.cli.scene --scene smoke3d --out data/smoke3d \\
      --res 112 64 112 --frames 200
  python -m nfs_tpu_torch.cli.scene --scene liquid3d --out data/liquid3d \\
      --res 64 64 64 --frames 100

``--device`` defaults to ``cuda``; a missing GPU is an error, there is
no CPU fallback.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="generate fluid data (.npz)")
    p.add_argument("--scene",
                   choices=["smoke2d", "smoke3d", "liquid2d", "liquid3d"],
                   required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--res", type=int, nargs="+", default=None)
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--warmup", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--uni", action="store_true",
                   help="also write mantaflow .uni files (3D densities)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda); a missing GPU is an "
                        "error, there is no CPU fallback")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from nfs_tpu_torch.io.npz import FrameStore

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device")
    os.makedirs(args.out, exist_ok=True)
    store = FrameStore(args.out)
    t0 = time.time()

    if args.scene.startswith("smoke"):
        from nfs_tpu_torch.sim.smoke import SmokeConfig, smoke_sequence

        if args.scene == "smoke2d":
            shape = tuple(args.res or (256, 192))
            cfg = SmokeConfig(shape=shape, source_center=(0.85, 0.5))
        else:
            shape = tuple(args.res or (112, 64, 112))
            # 3D: (z, y, x); smoke rises along -y => source near y_max
            cfg = SmokeConfig(shape=shape, source_center=(0.5, 0.85, 0.5))
        ds, vs = smoke_sequence(cfg, args.frames, warmup=args.warmup,
                                device=device)
        for t in range(args.frames):
            store.save_density(t, ds[t])
            store.save_velocity(t, vs[t])
            if args.uni and ds[t].ndim == 3:
                from nfs_tpu_torch.io.uni import write_uni
                write_uni(os.path.join(args.out, f"d_{t:04d}.uni"), ds[t])
    else:
        from nfs_tpu_torch.sim.flip import FlipConfig, liquid_sequence

        ndim = 2 if args.scene == "liquid2d" else 3
        shape = tuple(args.res or ((128,) * ndim))
        cfg = FlipConfig(shape=shape,
                         block_lo=(0.05,) + (0.3,) * (ndim - 1),
                         block_hi=(0.5,) + (0.7,) * (ndim - 1))
        xs, vels = liquid_sequence(cfg, args.frames, seed=args.seed,
                                   device=device)
        for t in range(args.frames):
            store.save_particles(t, x=xs[t], vel=vels[t],
                                 dens=np.ones(xs.shape[1], np.float32))

    print(f"wrote {args.frames} frames of {args.scene} "
          f"to {args.out} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
