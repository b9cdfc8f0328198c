"""Mesh construction over the ranks of a ``torch.distributed`` world
(counterpart of ``nfs_tpu/parallel/mesh.py``).

A :class:`Mesh` is the calling rank's view of a (frames, views) grid of
ranks: rank ``r = f * views + v`` holds frame shard ``f`` and view shard
``v``, frames outermost as in the JAX package, so that the views
reductions of every iteration stay among neighbouring ranks (one host)
and the frame halos, small and once per call, may cross hosts. Ranks
past ``frames * views`` take no shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The calling rank's place on a (frames, views) mesh.

    ``shape`` reads as ``jax.sharding.Mesh.shape``; ``frame_idx`` and
    ``view_idx`` are None on a rank past ``frames * views``;
    ``distributed`` says whether a process group exists (then every
    reduction and gather of the engine runs as a collective, even on an
    axis of one rank); ``frames_group`` holds the ranks of this rank's
    view shard (one per frame shard: the halo ring and the gathers),
    ``views_group`` those of its frame shard (the gradient all_reduce);
    both are None without a process group and on a rank without a shard.
    """

    shape: Dict[str, int]
    rank: int
    world: int
    distributed: bool
    frame_idx: Optional[int]
    view_idx: Optional[int]
    frames_group: Optional[object] = None
    views_group: Optional[object] = None

    @property
    def has_shard(self) -> bool:
        return self.frame_idx is not None

    def axis_index(self, axis: str) -> int:
        return self.frame_idx if axis == "frames" else self.view_idx

    def axis_ranks(self, axis: str) -> List[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        views = self.shape["views"]
        if axis == "frames":
            return [f * views + self.view_idx
                    for f in range(self.shape["frames"])]
        return [self.frame_idx * views + v for v in range(views)]

    def group(self, axis: str):
        return self.frames_group if axis == "frames" else self.views_group


def make_mesh(frames: int = 1, views: int = 1, space: int = 1) -> Mesh:
    """Build the (frames, views) mesh over the ranks of the current
    ``torch.distributed`` world (a world of one without a process group).

    ``frames * views`` may be less than the world size; the ranks left
    over take no shard but still receive the engine's gathered result.
    With a process group every rank must call this, in the same order,
    since it creates the axis groups (``dist.new_group``). ``space > 1``
    (spatial sharding of each frame's volume) is not ported.
    """
    if space > 1:
        raise NotImplementedError(
            "a space mesh axis (spatial sharding) is not ported to "
            "nfs_tpu_torch yet: ROADMAP queue 1, item 24")
    distributed = dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    need = frames * views * space
    if need > world:
        raise ValueError(
            f"mesh ({frames} frames x {views} views x {space} space = "
            f"{need}) exceeds {world} available devices")
    has_shard = rank < need
    frames_group = views_group = None
    if distributed:
        # every rank creates every group, in one order
        for v in range(views):
            g = dist.new_group([f * views + v for f in range(frames)])
            if has_shard and rank % views == v:
                frames_group = g
        for f in range(frames):
            g = dist.new_group([f * views + v for v in range(views)])
            if has_shard and rank // views == f:
                views_group = g
    return Mesh(shape={"frames": frames, "views": views}, rank=rank,
                world=world, distributed=distributed,
                frame_idx=rank // views if has_shard else None,
                view_idx=rank % views if has_shard else None,
                frames_group=frames_group, views_group=views_group)


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Default (frames, views) factorization of a device count: prefer a
    views axis of up to 2 (view rendering is cheap to reduce), everything
    else on frames (the embarrassingly parallel axis)."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1
