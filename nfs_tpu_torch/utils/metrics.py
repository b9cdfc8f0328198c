"""Structured JSONL metrics (a copy of ``nfs_tpu/utils/metrics.py``, which
needs no JAX): loss components, iterations per second and per-stage ms
as records of their own."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSONL metrics with a monotonic timestamp and run tag.

    >>> m = MetricsLogger("log/run/metrics.jsonl", tag="smoke_fire")
    >>> m.log(frame=3, loss=0.12, iters_per_sec=48.0)
    """

    def __init__(self, path: str, tag: Optional[str] = None,
                 echo: bool = False):
        self.path = path
        self.tag = tag
        self.echo = echo
        self._t0 = time.time()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, **fields):
        rec = {"t": round(time.time() - self._t0, 3)}
        if self.tag:
            rec["tag"] = self.tag
        rec.update(fields)
        line = json.dumps(rec)
        with open(self.path, "a") as f:
            f.write(line + "\n")
        if self.echo:
            print(line)

    def read(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(l) for l in f if l.strip()]
