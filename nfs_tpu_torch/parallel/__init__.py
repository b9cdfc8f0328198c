"""Multi-device layer of the grid path on ``torch.distributed``
(counterpart of ``nfs_tpu/parallel/``).

Axes of a :class:`~nfs_tpu_torch.parallel.mesh.Mesh` of ranks:

- ``frames``: the frames of a sequence are split over ranks; the window
  loss fetches +-W neighbour frames' velocities from the ring neighbours
  (:func:`~nfs_tpu_torch.parallel.sharding.halo_exchange`);
- ``views``: the camera views of each frame are split over ranks, whose
  partial gradients are summed with ``all_reduce``;
- ``space``: each frame's volume is split into y-slabs over ranks
  (``spatial.py``): advection takes halo rows from the neighbouring
  slabs, and the volume is gathered whole before it is rendered
  (:func:`stylize_frame_spatial`, and the composed (frames, views,
  space) mesh of :class:`ParallelSequenceStyler`).

The keyframe-parallel LNST engine (:class:`ParallelKeyframeStyler`,
``particles.py``) splits a particle sequence's keyframes over ``frames``.

One process per GPU (``torchrun``), NCCL between GPUs, gloo on the CPU.
The package exports what ``nfs_tpu.parallel`` does; the port's other
public names are in their modules (``mesh.Mesh``, ``mesh.mesh_shape_for``,
``sharding.gather_volume``, ``spatial.SpaceSlabs``, ...), as the JAX
package keeps its own there.
"""

from nfs_tpu_torch.parallel.engine import ParallelSequenceStyler
from nfs_tpu_torch.parallel.mesh import make_mesh
from nfs_tpu_torch.parallel.multihost import initialize_multihost
from nfs_tpu_torch.parallel.particles import ParallelKeyframeStyler
from nfs_tpu_torch.parallel.sharding import (
    halo_exchange, make_sharded_window_step, shard_volume)
from nfs_tpu_torch.parallel.spatial import (
    prepare_spatial, shard_volume_spatial, spatial_mesh,
    stylize_frame_spatial)

__all__ = [
    "make_mesh",
    "halo_exchange",
    "shard_volume",
    "make_sharded_window_step",
    "ParallelSequenceStyler",
    "ParallelKeyframeStyler",
    "initialize_multihost",
    "prepare_spatial",
    "shard_volume_spatial",
    "spatial_mesh",
    "stylize_frame_spatial",
]
