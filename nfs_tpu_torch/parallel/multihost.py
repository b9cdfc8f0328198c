"""Multi-process initialization (counterpart of
``nfs_tpu/parallel/multihost.py``).

The JAX package is single-controller: one process drives every device of
a host. The port is SPMD: one process per GPU, launched by ``torchrun``
(``torchrun --standalone --nproc_per_node N -m nfs_tpu_torch.cli.stylize
--parallel ...``), each running the same program on its own shard. A
single process (no launcher, or a world of one) needs no process group,
so entry points can call :func:`initialize_multihost` unconditionally.
Recovery is a restart from checkpoint; there is no in-flight elasticity.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_multihost(device="cuda") -> int:
    """Join the process group of a ``torchrun`` launch; returns the world
    size.

    Reads ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (and, through the
    ``env://`` rendezvous, ``MASTER_ADDR`` / ``MASTER_PORT``). With more
    than one rank it initializes ``torch.distributed`` with NCCL for a
    CUDA ``device`` (after ``torch.cuda.set_device(LOCAL_RANK)``) and gloo
    for the CPU. A single process does nothing and returns 1, and a
    process group that already exists is kept (its world size is
    returned). Anything else that goes wrong (a missing RANK, an
    unreachable rendezvous) raises: a misconfigured launch must never
    degrade to a silent single-process run.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 1
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world)
    return world


# Mesh-layout note: make_mesh numbers ranks frames-major (rank = frame
# shard * views + view shard), so with ranks enumerated host-major the
# views all_reduce of every iteration stays inside a host on NVLink and
# the frame halos (small, once per call) cross hosts.
