"""Sequence-level resume bookkeeping (counterpart of the
``SequenceManifest`` of ``nfs_tpu/io/checkpoint.py``).

A sequence job marks every finished frame in a JSON manifest; a rerun
skips the frames already done and continues the recursive warm-start
chain from the last saved ``param_%04d.npz`` (``cli/stylize.py``). The
manifest file has the JAX package's format, so either package resumes a
job the other started. In-frame checkpoints ({param, Adam state} every
``log_every`` iterations) are ROADMAP queue 1, item 16.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class SequenceManifest:
    """Frame-granular resume bookkeeping for sequence jobs: a JSON file
    mapping frame index -> output path + status."""

    def __init__(self, path: str):
        self.path = path
        self.state: Dict[str, Dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                self.state = json.load(f)

    def done(self, frame: int) -> bool:
        ent = self.state.get(str(frame))
        return bool(ent and ent.get("status") == "done"
                    and os.path.exists(ent.get("output", "")))

    def mark(self, frame: int, output: str, status: str = "done",
             **extra) -> None:
        self.state[str(frame)] = {"output": output, "status": status,
                                  **extra}
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=1)
        os.replace(tmp, self.path)
