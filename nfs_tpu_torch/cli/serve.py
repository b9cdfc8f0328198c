"""Persistent stylization service (counterpart of
``nfs_tpu/cli/serve.py``).

A long-lived worker process polls a spool directory for job files and
runs them through cached stylers: the loss network, the style targets
and the view pool are built once per config signature and reused by
every later job with that signature, and the input frames stay on the
device between jobs over the same files.

Protocol (a filesystem spool; works over any shared mount, no broker):

  <spool>/inbox/<job>.json     submitted by clients, atomic rename
  <spool>/work/<job>.json      claimed by the worker (rename = lock)
  <spool>/done/<job>.json      result manifest (status, outputs, timing)
  <spool>/worker_<pid>.json    liveness heartbeat + stats (atomic, ~5 s)
  <spool>/stop                 graceful shutdown marker

Job JSON:
  {"mode": "grid" | "particle",
   "data_dir": ..., "d_path": ..., "v_path": ..., "p_path": ...,
   "frames": [0, 1, ...],            # or {"start": 0, "count": N}
   "out_dir": ...,
   "config": {"optim.iters": 30, ...},   # StyleConfig overrides
   "style_target": "path.png",
   "grid_shape": [128, 128],            # particle mode
   "parallel": true}                    # all frames (grid) or all
                                        # keyframes (particle) jointly on
                                        # the engine's mesh (one process:
                                        # a (1, 1) mesh on one device)

Run:  python -m nfs_tpu_torch.cli.serve --spool /path/to/spool
      (``--device cuda`` by default; a missing GPU is an error)
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch


def _ensure_dirs(spool: str):
    for sub in ("inbox", "work", "done"):
        os.makedirs(os.path.join(spool, sub), exist_ok=True)


def submit_job(spool: str, job: dict, name: str = None) -> str:
    """Client helper: atomically drop a job into the spool inbox."""
    _ensure_dirs(spool)
    name = name or f"job_{int(time.time() * 1000)}_{os.getpid()}"
    tmp = os.path.join(spool, f".{name}.tmp")
    with open(tmp, "w") as f:
        json.dump(job, f)
    dst = os.path.join(spool, "inbox", f"{name}.json")
    os.replace(tmp, dst)
    return name


def _config_from_job(job: dict):
    """The job's StyleConfig; list values become tuples, so the config
    stays hashable (the styler cache's key)."""
    from nfs_tpu_torch.core.config import StyleConfig, replace

    over = dict(job.get("config", {}))
    if job.get("style_target"):
        over["loss.style_target"] = job["style_target"]
    return replace(StyleConfig(), **over)


def _job_frames(job: dict):
    fr = job.get("frames", [0])
    if isinstance(fr, dict):
        return list(range(fr.get("start", 0),
                          fr.get("start", 0) + fr.get("count", 1)))
    return list(fr)


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


class StylizeWorker:
    """Caches one styler per (mode, config, grid_shape, parallel)
    signature, so repeat jobs skip the loss network and target set-up.

    Input frames are also cached on the device (an LRU bounded in bytes,
    keyed on the frame files' (path, mtime_ns, size), so an overwritten
    file uploads again): two queued jobs over the same sequence (a style
    sweep, an iteration escalation) copy it host to device once. The
    stylers take a tensor already on their device without a copy."""

    #: device frame-cache budget (bytes); override via NFS_TPU_SERVE_CACHE_MB
    cache_bytes = 2 << 30

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device")
        self._stylers: Dict[Tuple, object] = {}
        self._frame_cache: "OrderedDict[Tuple, tuple]" = OrderedDict()
        self._frame_cache_bytes = 0
        mb = os.environ.get("NFS_TPU_SERVE_CACHE_MB")
        if mb:
            self.cache_bytes = int(mb) * (1 << 20)
        self.stats = {"jobs": 0, "frames": 0, "errors": 0,
                      "styler_cache_hits": 0,
                      "frame_cache_hits": 0, "frame_cache_misses": 0,
                      "upload_s_saved_est": 0.0}

    # ---- device-resident input cache ---------------------------------- #

    def _file_sig(self, store, pattern: str, frames) -> Tuple:
        sig = []
        for t in frames:
            path = store._path(pattern, t)
            st = os.stat(path)
            sig.append((path, st.st_mtime_ns, st.st_size))
        return tuple(sig)

    def _cache_get(self, key: Tuple):
        if key in self._frame_cache:
            self._frame_cache.move_to_end(key)
            val, _, upload_s = self._frame_cache[key]
            self.stats["frame_cache_hits"] += 1
            # the miss's read + upload time, which this hit skipped
            self.stats["upload_s_saved_est"] = round(
                self.stats["upload_s_saved_est"] + upload_s, 3)
            return val
        return None

    def _cache_put(self, key: Tuple, val, nbytes: int, upload_s: float):
        self.stats["frame_cache_misses"] += 1
        if nbytes > self.cache_bytes:
            return  # larger than the whole budget: don't thrash
        self._frame_cache[key] = (val, nbytes, upload_s)
        self._frame_cache_bytes += nbytes
        while self._frame_cache_bytes > self.cache_bytes:
            _, (_, old_bytes, _) = self._frame_cache.popitem(last=False)
            self._frame_cache_bytes -= old_bytes

    def _upload(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _sync(self):
        # the clock must include the host-to-device copy
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load_grid_cached(self, store, job, frames):
        """(T,)-stacked density (and velocity) tensors of ``frames`` on
        the device, reused across jobs while the files are unchanged."""
        v_pat = job.get("v_path", "v_%04d.npz")
        has_v = store.exists(v_pat, frames[0])
        key = ("grid", self._file_sig(store, store.d_path, frames),
               self._file_sig(store, v_pat, frames) if has_v else None)
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        t0 = time.time()
        d = self._upload(np.stack([store.load_density(t) for t in frames]))
        v = (self._upload(np.stack([store.load_velocity(t)
                                    for t in frames]))
             if has_v else None)
        self._sync()
        self._cache_put(key, (d, v), _nbytes(d) + _nbytes(v),
                        time.time() - t0)
        return d, v

    def _load_particles_cached(self, store, job, frames):
        from nfs_tpu_torch.core.pytrees import ParticleSet

        key = ("particles", self._file_sig(store, store.p_path, frames))
        hit = self._cache_get(key)
        if hit is not None:
            return hit
        t0 = time.time()
        psets, nbytes = [], 0
        for t in frames:
            raw = store.load_particles(t)
            pset = ParticleSet(
                x=self._upload(raw["x"]),
                dens=self._upload(raw["dens"]) if "dens" in raw else None)
            nbytes += _nbytes(pset.x) + _nbytes(pset.dens)
            psets.append(pset)
        self._sync()
        self._cache_put(key, psets, nbytes, time.time() - t0)
        return psets

    def _styler(self, job: dict):
        mode = job.get("mode", "grid")
        cfg = _config_from_job(job)
        grid_shape = tuple(job.get("grid_shape", ())) or None
        parallel = bool(job.get("parallel", False))
        sig = (mode, cfg, grid_shape, parallel)
        if sig in self._stylers:
            self.stats["styler_cache_hits"] += 1
            return self._stylers[sig]
        if mode == "particle":
            from nfs_tpu_torch.styler.particle import ParticleStyler

            styler = ParticleStyler(cfg, grid_shape=grid_shape,
                                    device=self.device)
            if parallel:
                from nfs_tpu_torch.parallel import ParallelKeyframeStyler

                # every keyframe in one program on the (1, 1) mesh of
                # the service's one process
                styler = ParallelKeyframeStyler(styler)
        else:
            from nfs_tpu_torch.styler.grid import GridStyler

            styler = GridStyler(cfg, device=self.device)
            if parallel:
                from nfs_tpu_torch.parallel import ParallelSequenceStyler

                # the mesh of mesh_shape_for(world size): (1, 1) in the
                # one process of the service
                styler = ParallelSequenceStyler(styler)
        self._stylers[sig] = styler
        return styler

    def run_job(self, job: dict) -> dict:
        from nfs_tpu_torch.io.npz import FrameStore

        t0 = time.time()
        cfg = _config_from_job(job)
        frames = _job_frames(job)
        out_dir = job["out_dir"]
        os.makedirs(out_dir, exist_ok=True)
        store = FrameStore(job["data_dir"],
                           job.get("d_path", "d_%04d.npz"),
                           job.get("v_path", "v_%04d.npz"),
                           job.get("p_path", "p_%04d.npz"))
        out_store = FrameStore(out_dir)
        styler = self._styler(job)
        outputs = []

        if job.get("mode", "grid") == "particle":
            psets = self._load_particles_cached(store, job, frames)
            for i, styled in styler.stylize_keyframes(psets):
                t = frames[i]
                out_store.save_particles(
                    t, x=styled.x.cpu().numpy(),
                    dens=styled.dens.cpu().numpy())
                outputs.append(f"p_{t:04d}.npz")
        else:
            densities, vels = self._load_grid_cached(store, job, frames)
            if job.get("parallel"):
                # the mesh engine: all frames in one joint optimization
                d_star, _, _ = styler.stylize(densities, vels)
                for i, t in enumerate(frames):
                    out_store.save_density(t, d_star[i].cpu().numpy())
                    outputs.append(f"d_{t:04d}.npz")
            elif len(frames) == 1 and cfg.optim.window == 0:
                d_star, _, _ = styler.stylize_frame(densities[0])
                out_store.save_density(frames[0], d_star.cpu().numpy())
                outputs.append(f"d_{frames[0]:04d}.npz")
            else:
                for i, d_star, _ in styler.stylize_sequence(
                        densities, vels):
                    t = frames[i]
                    out_store.save_density(t, d_star.cpu().numpy())
                    outputs.append(f"d_{t:04d}.npz")

        self.stats["jobs"] += 1
        self.stats["frames"] += len(frames)
        return {"status": "ok", "outputs": outputs,
                "frames": len(frames),
                "wall_s": round(time.time() - t0, 3)}


def serve(spool: str, poll_s: float = 0.5, max_jobs: int = None,
          idle_timeout_s: float = None, device="cuda") -> dict:
    """Worker loop: claim inbox jobs by rename, run them on ``device``,
    write result manifests. Returns the worker's stats on shutdown (stop
    file, max_jobs, or idle timeout)."""
    _ensure_dirs(spool)
    worker = StylizeWorker(device)
    stop_marker = os.path.join(spool, "stop")
    hb_path = os.path.join(spool, f"worker_{os.getpid()}.json")
    started = time.time()
    last_work = time.time()
    last_hb = 0.0

    def heartbeat(status: str):
        # liveness + stats, written atomically so monitors never read a
        # torn file; one file per worker pid
        nonlocal last_hb
        blob = {"pid": os.getpid(), "status": status,
                "started": round(started, 3),
                "uptime_s": round(time.time() - started, 3),
                "idle_s": round(time.time() - last_work, 3),
                "stats": worker.stats}
        with open(hb_path + ".tmp", "w") as f:
            json.dump(blob, f)
        os.replace(hb_path + ".tmp", hb_path)
        last_hb = time.time()

    while True:
        if time.time() - last_hb > 5.0:
            heartbeat("polling")
        if os.path.exists(stop_marker):
            break
        # max_jobs counts PROCESSED jobs (success + error): a stream of
        # failing jobs must still end the worker, not spin forever
        processed = worker.stats["jobs"] + worker.stats["errors"]
        if max_jobs is not None and processed >= max_jobs:
            break
        if (idle_timeout_s is not None
                and time.time() - last_work > idle_timeout_s):
            break
        pending = sorted(os.listdir(os.path.join(spool, "inbox")))
        if not pending:
            time.sleep(poll_s)
            continue
        name = pending[0]
        src = os.path.join(spool, "inbox", name)
        claimed = os.path.join(spool, "work", name)
        try:
            os.rename(src, claimed)  # atomic claim (multi-worker safe)
        except OSError:
            continue  # another worker got it
        with open(claimed) as f:
            job = json.load(f)
        try:
            result = worker.run_job(job)
        except Exception as e:  # job fails, worker survives
            worker.stats["errors"] += 1
            result = {"status": "error",
                      "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()}
        result["job"] = job
        done = os.path.join(spool, "done", name)
        with open(done + ".tmp", "w") as f:
            json.dump(result, f)
        os.replace(done + ".tmp", done)
        os.unlink(claimed)
        last_work = time.time()
        heartbeat("working")
        print(f"[serve] {name}: {result['status']} "
              f"({result.get('wall_s', '-')}s)", flush=True)
    heartbeat("stopped")
    return worker.stats


def main(argv=None):
    p = argparse.ArgumentParser(description="stylization service worker")
    p.add_argument("--spool", required=True)
    p.add_argument("--poll", type=float, default=0.5)
    p.add_argument("--max_jobs", type=int, default=None)
    p.add_argument("--idle_timeout", type=float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda); a missing GPU is an "
                        "error, there is no CPU fallback")
    args = p.parse_args(argv)
    stats = serve(args.spool, poll_s=args.poll, max_jobs=args.max_jobs,
                  idle_timeout_s=args.idle_timeout, device=args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
