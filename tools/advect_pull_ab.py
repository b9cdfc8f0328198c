#!/usr/bin/env python3
"""A/B of the K2 / K3b kernels of this checkout against another build of
``advect.cu``: one whose K2 and K3b take no tile (the per-cell pull from
device memory, e.g. ``git show 6dc3456:nfs_tpu_torch/csrc/advect.cu``),
or with ``--tiled=TZ,TY,TX`` one with this checkout's C interface,
launched on that tile with its 16 bytes per staged source.

    python3 tools/advect_pull_ab.py REFERENCE_ADVECT_CU [--tiled=TZ,TY,TX]

On ``chip_smoke.py``'s kernel-phase inputs (112x64x112, seed 99: random
at max_disp 2 and 3, the density slice's swirl at max_disp 2) it prints
one JSON line per kernel (K2, K3b, and K3, whose code K3b shares) and
input: the largest difference between the two builds, whether they are
bitwise equal, and, in turns this build, reference, reference, this
build, each launched straight through its C interface, with
``chip_smoke.py``'s two timers (``ms``: one call between CUDA events,
host included; ``device_ms``: queued calls, device only). Beside them,
once each: the wrapper that the port calls and
``grid_sampler_3d_backward``. Then K2 and K3b on the tiles of ``TILES``,
each bitwise equal to the plan's tile. Needs one GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# tiles (TZ, TY, TX) timed beside the plan's at max_disp 2
TILES = ((8, 4, 24), (8, 8, 24), (4, 4, 24), (4, 7, 24), (3, 8, 24),
         (4, 4, 48), (2, 8, 48))


def _launch(lib, key, f, g, v, md, tile):
    """K2, K3b or K3 of ``lib`` on (f, g, v); ``tile`` None launches the
    reference's interface (radius, no tile)."""
    import torch

    from nfs_tpu_torch.ops import advect_kernels as ak

    D, H, W = g.shape
    R = ak._radius(md)
    stream = ak._stream(g.device)
    if key == "bwd_vel":
        gs = torch.empty_like(v)
        ak._raise_on(lib.nfs_advect_bwd_vel(
            f.data_ptr(), v.data_ptr(), g.data_ptr(), gs.data_ptr(), D, H, W,
            md, stream), key)
        return gs
    fused = key == "bwd_fused"
    tile_args = () if tile is None else (
        *tile, ak._staged_bytes(R, tile, fused))
    gf = torch.empty_like(g)
    if not fused:
        ak._raise_on(lib.nfs_advect_bwd_field(
            v.data_ptr(), g.data_ptr(), gf.data_ptr(), D, H, W, md, R,
            *tile_args, stream), key)
        return gf
    gs = torch.empty_like(v)
    ak._raise_on(lib.nfs_advect_bwd_fused(
        f.data_ptr(), v.data_ptr(), g.data_ptr(), gf.data_ptr(),
        gs.data_ptr(), D, H, W, md, R, *tile_args, stream), key)
    return gf, gs


def _load_reference(source: Path, tiled: bool) -> ctypes.CDLL:
    from nfs_tpu_torch.ops import _cuda_build

    lib = ctypes.CDLL(str(_cuda_build.build_library(source,
                                                    "nfs_advect_reference")))
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if tiled:
        lib.nfs_advect_bwd_field.argtypes = [p, p, p, i, i, i, fl, i, i, i,
                                             i, i, p]
        lib.nfs_advect_bwd_fused.argtypes = [p, p, p, p, p, i, i, i, fl, i,
                                             i, i, i, i, p]
        lib.nfs_advect_bwd_vel.argtypes = [p, p, p, p, i, i, i, fl, p]
        return lib
    lib.nfs_advect_bwd_field.argtypes = [p, p, p, i, i, i, fl, i, p]
    lib.nfs_advect_bwd_fused.argtypes = [p, p, p, p, p, i, i, i, fl, i, p]
    lib.nfs_advect_bwd_vel.argtypes = [p, p, p, p, i, i, i, fl, p]
    return lib


def _times(fn) -> dict:
    return {"ms": cs._median_ms(fn), "device_ms": cs._device_ms(fn)}


def main(argv) -> int:
    import torch

    tiled = [a for a in argv if a.startswith("--tiled=")]
    argv = [a for a in argv if a not in tiled]
    if len(argv) != 1 or len(tiled) > 1:
        raise SystemExit(__doc__)
    ref_tile = (tuple(int(n) for n in tiled[0].split("=")[1].split(","))
                if tiled else None)
    if not torch.cuda.is_available():
        raise RuntimeError("advect_pull_ab needs a CUDA device")
    from nfs_tpu_torch.ops import advect_kernels as ak

    card = cs.phase_device()[1]
    lib = ak.load_library()
    ref = _load_reference(Path(argv[0]), bool(tiled))
    pairs = cs._advect_pairs()
    for case, md in (("random", 2.0), ("random", 3.0), ("swirl", 2.0)):
        f, g, v = cs._cuda_inputs(case, md, seed=99)
        for key in ("bwd_field", "bwd_fused", "bwd_vel"):
            tile = (None if key == "bwd_vel" else
                    ak._pull_plan(ak._radius(md), key == "bwd_fused")[:3])
            new = _launch(lib, key, f, g, v, md, tile)
            old = _launch(ref, key, f, g, v, md,
                          None if key == "bwd_vel" else ref_tile)
            turns = {"this": [], "reference": []}
            for who in ("this", "reference", "reference", "this"):
                turns[who].append(_times(
                    (lambda: _launch(lib, key, f, g, v, md, tile))
                    if who == "this" else
                    (lambda: _launch(ref, key, f, g, v, md,
                                     None if key == "bwd_vel" else
                                     ref_tile))))
            kern = pairs[key][0]
            cs.emit({"phase": "pull_ab", "kernel": key, "inputs": case,
                     "max_disp": md, "tile": tile,
                     "max_abs_diff": cs._max_err(new, old),
                     "bitwise_equal": cs._equal(new, old), **turns,
                     "wrapper": _times(lambda: kern(f, g, v, md)),
                     "library": _times(cs._advect_library_call(
                         key, f, g, v, md)),
                     "card": card})
    f, g, v = cs._cuda_inputs("random", 2.0, seed=99)
    for key in ("bwd_field", "bwd_fused"):
        plan = ak._pull_plan(2, key == "bwd_fused")
        want = _launch(lib, key, f, g, v, 2.0, plan[:3])
        for tile in (plan[:3], *TILES):
            got = _launch(lib, key, f, g, v, 2.0, tile)
            if not cs._equal(got, want):
                raise AssertionError(f"{key}: tile {tile} differs from the "
                                     f"plan's {plan[:3]}")
            cs.emit({"phase": "pull_tile", "kernel": key, "tile": tile,
                     "smem_bytes": ak._staged_bytes(2, tile,
                                                    key == "bwd_fused"),
                     **_times(lambda: _launch(lib, key, f, g, v, 2.0,
                                              tile)),
                     "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
