"""Sequence block streaming (counterpart of ``nfs_tpu/io/stream.py``, a
copy: the module is numpy only, and the port imports nothing of the JAX
package).

Long sequences are cached as a DIRECTORY of per-chunk npz files plus a
meta.json, written incrementally by resumable generation
(nfs_tpu_torch.sim.smoke.smoke_sequence_cached) and consumed incrementally
by GridStyler.stylize_sequence_blocks. Per-block reads keep host memory
and device memory at one block, so sequence length is unbounded. The
layout is the JAX package's, so either package reads a directory the
other wrote.

Layout:
  <cache_dir>/meta.json              {"n_frames": N, "chunk": C}
  <cache_dir>/chunk_00000.npz        {"d": (C, *sp), "v": (C, *sp, nd)}
  <cache_dir>/chunk_00016.npz        (named by start frame)
  ...
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterator, Optional, Tuple

import numpy as np


def sequence_cache_complete(path: str) -> bool:
    """True if `path` is a complete sequence cache: a legacy single .npz
    or a chunk directory with meta.json."""
    if os.path.isfile(path):
        return True
    return os.path.isfile(os.path.join(path, "meta.json"))


def finalize_sequence_dir(part_dir: str, n_frames: int, chunk: int
                          ) -> None:
    """Mark a chunk directory as a complete cache (writes meta.json;
    chunk files stay as-is — no concatenation pass)."""
    meta = {"n_frames": int(n_frames), "chunk": int(chunk)}
    tmp = os.path.join(part_dir, "meta_tmp.json")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(part_dir, "meta.json"))


def _chunk_paths(cache_dir: str):
    import re

    # digits only: never pick up tmp/garbage files from interrupted runs
    pat = re.compile(r"chunk_\d+\.npz$")
    return sorted(p for p in glob.glob(
        os.path.join(cache_dir, "chunk_*.npz")) if pat.search(p))


def load_sequence_cache(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load a full sequence into host memory (legacy npz or chunk dir)."""
    if os.path.isfile(path):
        with np.load(path) as z:
            return np.asarray(z["d"]), np.asarray(z["v"])
    ds, vs = [], []
    for c in _chunk_paths(path):
        with np.load(c) as z:
            ds.append(np.asarray(z["d"]))
            vs.append(np.asarray(z["v"]))
    return np.concatenate(ds), np.concatenate(vs)


def iter_sequence_blocks(path: str, halo: int,
                         n_frames: Optional[int] = None
                         ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yield (t0, dens_block, vels_ctx) blocks for
    GridStyler.stylize_sequence_blocks.

    vels_ctx covers global frames [t0 - P, t0 + B + P) with
    P = max(halo, 1); at the true sequence boundaries the edge velocity
    frame is replicated — matching the clamped neighbor indexing of the
    in-memory sequence stylizer.

    A one-chunk lookahead is kept so each block's right halo comes from
    the next chunk without re-reading files.
    """
    P = max(int(halo), 1)
    if os.path.isfile(path):  # legacy single npz: one big block
        with np.load(path) as z:
            ds, vs = np.asarray(z["d"]), np.asarray(z["v"])
        if n_frames is not None:
            ds, vs = ds[:n_frames], vs[:n_frames]
        ctx = np.concatenate([np.repeat(vs[:1], P, axis=0), vs,
                              np.repeat(vs[-1:], P, axis=0)])
        yield 0, ds, ctx
        return

    import re

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    total = meta["n_frames"] if n_frames is None else min(
        n_frames, meta["n_frames"])
    paths = _chunk_paths(path)
    starts = [int(re.search(r"chunk_(\d+)\.npz", p).group(1))
              for p in paths]

    # bounded LRU of decoded chunks: a halo deeper than the chunk size
    # must read TRUE frames several chunks over (not replicate the
    # nearest one — that silently feeds wrong velocity context to the
    # outer window taps). Keep enough chunks for block + both halos.
    cache: dict = {}
    lru: list = []
    chunk_nominal = max(1, int(meta.get("chunk", 1)))
    keep = max(3, 2 + (P + chunk_nominal - 1) // chunk_nominal * 2)

    def read(i):
        if i in cache:
            lru.remove(i)
            lru.append(i)
            return cache[i]
        with np.load(paths[i]) as z:
            cache[i] = (np.asarray(z["d"]), np.asarray(z["v"]))
        lru.append(i)
        while len(lru) > keep:
            del cache[lru.pop(0)]
        return cache[i]

    def chunk_of(g):
        lo = 0
        for j in range(len(starts) - 1, -1, -1):
            if starts[j] <= g:
                lo = j
                break
        return lo

    def v_frames(a, b):
        """Velocity frames for global range [a, b), indices clipped to
        [0, total) with edge replication (clamp-at-boundary semantics)."""
        out = []
        for g in range(a, b):
            gc = min(max(g, 0), total - 1)
            j = chunk_of(gc)
            out.append(read(j)[1][gc - starts[j]])
        return np.stack(out) if out else None

    t0 = 0
    for i in range(len(paths)):
        if t0 >= total:
            break
        d, v = read(i)
        take = min(d.shape[0], total - t0)
        d, v = d[:take], v[:take]
        left = v_frames(t0 - P, t0)
        right = v_frames(t0 + take, t0 + take + P)
        yield t0, d, np.concatenate([left, v, right])
        t0 += take
