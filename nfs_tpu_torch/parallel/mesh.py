"""Mesh construction over the ranks of a ``torch.distributed`` world
(counterpart of ``nfs_tpu/parallel/mesh.py``).

A :class:`Mesh` is the calling rank's view of a (frames, views, space)
grid of ranks: rank ``r = (f * views + v) * space + s`` holds frame shard
``f``, view shard ``v`` and y-slab ``s`` of every frame's volume, frames
outermost and space innermost as in the JAX package: the volume halos of
every advection tap stay among neighbouring ranks, the views reductions
of every iteration next to them (one host), and the frame halos, small
and once per call, may cross hosts. Ranks past ``frames * views * space``
take no shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

AXES = ("frames", "views", "space")


@dataclass(frozen=True)
class Mesh:
    """The calling rank's place on a (frames, views, space) mesh.

    ``shape`` reads as ``jax.sharding.Mesh.shape``: it has a ``space`` key
    only when space > 1, as JAX's mesh has a ``space`` axis only then.
    ``frame_idx``, ``view_idx`` and ``space_idx`` are None on a rank past
    ``frames * views * space``; ``distributed`` says whether a process
    group exists (then every reduction and gather of the engine runs as a
    collective, even on an axis of one rank). ``frames_group`` holds the
    ranks of this rank's (view, space) shard (one per frame shard: the
    halo ring and the gathers), ``views_group`` those of its (frame,
    space) shard (the gradient all_reduce of one slab), ``space_group``
    those of its (frame, view) shard (the y-halos and y-gathers); all are
    None without a process group and on a rank without a shard.
    """

    shape: Dict[str, int]
    rank: int
    world: int
    distributed: bool
    frame_idx: Optional[int]
    view_idx: Optional[int]
    frames_group: Optional[object] = None
    views_group: Optional[object] = None
    space_idx: Optional[int] = 0
    space_group: Optional[object] = None

    @property
    def has_shard(self) -> bool:
        return self.frame_idx is not None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis: str) -> int:
        return {"frames": self.frame_idx, "views": self.view_idx,
                "space": self.space_idx}[axis]

    def axis_ranks(self, axis: str) -> List[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        idx = {a: self.axis_index(a) for a in AXES}
        out = []
        for i in range(self.size(axis)):
            idx[axis] = i
            out.append(_rank(idx["frames"], idx["views"], idx["space"],
                             self.size("views"), self.size("space")))
        return out

    def group(self, axis: str):
        return {"frames": self.frames_group, "views": self.views_group,
                "space": self.space_group}[axis]


def _rank(f: int, v: int, s: int, views: int, space: int) -> int:
    return (f * views + v) * space + s


def make_mesh(frames: int = 1, views: int = 1, space: int = 1) -> Mesh:
    """Build the (frames, views, space) mesh over the ranks of the current
    ``torch.distributed`` world (a world of one without a process group).

    ``frames * views * space`` may be less than the world size; the ranks
    left over take no shard but still receive the engine's gathered
    result. With a process group every rank must call this, in the same
    order, since it creates the axis groups (``dist.new_group``).
    """
    distributed = dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    need = frames * views * space
    if need > world:
        raise ValueError(
            f"mesh ({frames} frames x {views} views x {space} space = "
            f"{need}) exceeds {world} available devices")
    has_shard = rank < need
    sizes = {"frames": frames, "views": views, "space": space}
    mine = {"frames": rank // (views * space),
            "views": rank // space % views, "space": rank % space}
    groups = dict.fromkeys(AXES)
    if distributed:
        # every rank creates every group, in one order: for each axis, one
        # group per position on the other two (a space axis of one rank
        # needs none: the slab code does no communication on it)
        for axis in AXES[:2] + (("space",) if space > 1 else ()):
            a, b = (x for x in AXES if x != axis)
            for i in range(sizes[a]):
                for j in range(sizes[b]):
                    idx = {a: i, b: j}
                    ranks = []
                    for k in range(sizes[axis]):
                        idx[axis] = k
                        ranks.append(_rank(idx["frames"], idx["views"],
                                           idx["space"], views, space))
                    g = dist.new_group(ranks)
                    if has_shard and (mine[a], mine[b]) == (i, j):
                        groups[axis] = g
    shape = {"frames": frames, "views": views}
    if space > 1:
        shape["space"] = space
    return Mesh(shape=shape, rank=rank, world=world,
                distributed=distributed,
                frame_idx=mine["frames"] if has_shard else None,
                view_idx=mine["views"] if has_shard else None,
                frames_group=groups["frames"], views_group=groups["views"],
                space_idx=mine["space"] if has_shard else None,
                space_group=groups["space"])


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Default (frames, views) factorization of a device count: prefer a
    views axis of up to 2 (view rendering is cheap to reduce), everything
    else on frames (the embarrassingly parallel axis)."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1
