"""In-frame checkpoints and sequence-level resume bookkeeping
(counterpart of ``nfs_tpu/io/checkpoint.py``).

In-frame: :func:`save_checkpoint` writes a tree of tensors (dicts,
:class:`~nfs_tpu_torch.styler.octave.AdamState` and tensors or ints) and
JSON metadata to ONE ``.npz``: each leaf under ``leaf:<path>`` (its keys
and field names joined by ``/``), the metadata as ``__meta__``. No pickle.
The write is atomic (a temp file in the same directory, then a rename),
so a crash mid-write leaves the previous checkpoint intact.
:func:`load_checkpoint` reads one back into the structure, dtypes and
device of a template tree.

The paths are the JAX package's, which flattens optax's Adam state, the
tuple ``(ScaleByAdamState(count, mu, nu), EmptyState())``, with
``jax.tree_util`` key paths: an :class:`AdamState` ``s`` is stored as
``s/0/count`` (an int32 0-d array), ``s/0/mu`` and ``s/0/nu`` (each the
param's tree: a tensor, or the ``{'field', 'tf'}`` dict of
``render.train_transfer``: ``s/0/mu/field``, ...). So either package
resumes a frame the other checkpointed, ``GridStyler.stylize_frame``'s
``<log_dir>/<tag>/inframe_ckpt.npz`` of a ``--checkpoint_in_frame`` job
too. :func:`load_checkpoint` also reads the layout the port wrote before
(``s/count``, ``s/mu``, ``s/nu``), so a frame interrupted then resumes.

Sequence: a job marks every finished frame in a JSON manifest; a rerun
skips the frames already done and continues the recursive warm-start
chain from the last saved ``param_%04d.npz`` (``cli/stylize.py``). The
manifest file has the JAX package's format too.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from nfs_tpu_torch.styler.octave import AdamState

# optax.adam's state is a chain of two: ScaleByAdamState, then the empty
# state of scale_by_learning_rate; AdamState's fields are the first's
_ADAM_PREFIX = "0/"


def _flatten(tree: Any, prefix: str = "", legacy: bool = False):
    """(path, leaf) pairs of a tree of dicts, dataclasses and leaves, in
    the JAX package's paths (``legacy``: the port's paths before the JAX
    ones, without optax's ``0/`` under an AdamState)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten(tree[k], f"{prefix}{k}/", legacy)
    elif dataclasses.is_dataclass(tree):
        if isinstance(tree, AdamState) and not legacy:
            prefix += _ADAM_PREFIX
        for f in dataclasses.fields(tree):
            yield from _flatten(getattr(tree, f.name), f"{prefix}{f.name}/",
                                legacy)
    else:
        yield prefix[:-1], tree


def _rebuild(like: Any, leaves):
    """``like``'s structure with its leaves taken in :func:`_flatten`'s
    order from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves) for k, v in like.items()}
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    return next(leaves)


def save_checkpoint(path: str, tree: Any, meta: Optional[Dict] = None
                    ) -> None:
    """Atomically save a tree of tensors (+ JSON-able metadata)."""
    arrays = {}
    for p, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        elif isinstance(leaf, int):     # Adam's count, as optax keeps it
            leaf = np.int32(leaf)
        arrays["leaf:" + p] = np.asarray(leaf)
    if meta is not None:
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_meta(path: str) -> Optional[Dict]:
    """The JSON metadata of a checkpoint, or None if it has none."""
    with np.load(path) as npz:
        if "__meta__" not in npz.files:
            return None
        return json.loads(bytes(npz["__meta__"]).decode())


def load_checkpoint(path: str, like: Any) -> Tuple[Any, Optional[Dict]]:
    """Load a checkpoint into the structure of ``like`` (a tree of the
    same layout, e.g. freshly initialized state): tensor leaves come back
    with the dtype and device of ``like``'s, int leaves as ints. Reads
    the JAX package's paths and the port's older ones. Returns (tree,
    meta)."""
    leaves = []
    with np.load(path) as npz:
        for (p, leaf), (old, _) in zip(_flatten(like),
                                       _flatten(like, legacy=True)):
            key = "leaf:" + p
            if key not in npz.files and "leaf:" + old in npz.files:
                key = "leaf:" + old
            if key not in npz.files:
                raise KeyError(f"checkpoint {path} missing leaf leaf:{p}")
            arr = npz[key]
            if isinstance(leaf, torch.Tensor):
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(
                        f"checkpoint {path} leaf {key} has shape "
                        f"{arr.shape}, expected {tuple(leaf.shape)}")
                leaves.append(torch.as_tensor(arr).to(dtype=leaf.dtype,
                                                      device=leaf.device))
            else:
                leaves.append(type(leaf)(arr))
    return _rebuild(like, iter(leaves)), read_meta(path)


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
