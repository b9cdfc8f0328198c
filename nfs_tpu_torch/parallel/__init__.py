"""Multi-device layer of the grid path on ``torch.distributed``
(counterpart of ``nfs_tpu/parallel/``).

Axes of a :class:`~nfs_tpu_torch.parallel.mesh.Mesh` of ranks:

- ``frames``: the frames of a sequence are split over ranks; the window
  loss fetches +-W neighbour frames' velocities from the ring neighbours
  (:func:`~nfs_tpu_torch.parallel.sharding.halo_exchange`);
- ``views``: the camera views of each frame are split over ranks, whose
  partial gradients are summed with ``all_reduce``.

The keyframe-parallel LNST engine (:class:`ParallelKeyframeStyler`,
``particles.py``) splits a particle sequence's keyframes over ``frames``.

One process per GPU (``torchrun``), NCCL between GPUs, gloo on the CPU.
Not ported yet: spatial sharding of a frame's volume (``spatial.py``,
``shard_volume`` and the mesh's ``space`` axis, ROADMAP queue 1, item
24).
"""

from nfs_tpu_torch.parallel.engine import ParallelSequenceStyler
from nfs_tpu_torch.parallel.mesh import Mesh, make_mesh, mesh_shape_for
from nfs_tpu_torch.parallel.multihost import initialize_multihost
from nfs_tpu_torch.parallel.particles import ParallelKeyframeStyler
from nfs_tpu_torch.parallel.sharding import (
    halo_exchange, make_sharded_window_step)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_shape_for",
    "halo_exchange",
    "make_sharded_window_step",
    "ParallelSequenceStyler",
    "ParallelKeyframeStyler",
    "initialize_multihost",
]
