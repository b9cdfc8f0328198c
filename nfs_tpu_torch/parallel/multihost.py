"""Multi-process initialization (counterpart of
``nfs_tpu/parallel/multihost.py``).

The JAX package is single-controller: one process drives every device of
a host. The port is SPMD: one process per GPU, launched by ``torchrun``
(``torchrun --standalone --nproc_per_node N -m nfs_tpu_torch.cli.stylize
--parallel ...``), each running the same program on its own shard. A
single process (no launcher, or a world of one) needs no process group,
so entry points can call :func:`initialize_multihost` unconditionally.
A launcher of its own passes the rendezvous explicitly (``coordinator``,
``num_processes``, ``process_id``, as the JAX function takes them).
Recovery is a restart from checkpoint; there is no in-flight elasticity.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize_multihost(device="cuda", coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> int:
    """Join the process group of a multi-process launch; returns the
    world size.

    With ``coordinator`` (``"host:port"``), ``num_processes`` and
    ``process_id`` (as ``jax.distributed.initialize`` takes them) the
    ranks meet at ``tcp://host:port``, with that world size and this
    rank, and no environment variable is read; all three are needed
    together (ValueError otherwise). With none it reads a ``torchrun``
    launch's ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (and, through
    the ``env://`` rendezvous, ``MASTER_ADDR`` / ``MASTER_PORT``), and a
    single process does nothing and returns 1.

    More than one rank initializes ``torch.distributed`` with NCCL for a
    CUDA ``device`` (after ``torch.cuda.set_device`` to the local rank:
    ``LOCAL_RANK``, or the rank modulo the host's GPUs with explicit
    arguments) and gloo for the CPU. A process group that already exists
    is kept (its world size is returned). Anything else that goes wrong
    (a missing RANK, an unreachable rendezvous) raises: a misconfigured
    launch must never degrade to a silent single-process run.
    """
    given = (coordinator, num_processes, process_id)
    if any(a is not None for a in given) and any(a is None for a in given):
        raise ValueError(
            "initialize_multihost: coordinator, num_processes and "
            "process_id go together; got coordinator="
            f"{coordinator!r}, num_processes={num_processes!r}, "
            f"process_id={process_id!r}")
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator is not None:
        world, rank = int(num_processes), int(process_id)
        if not 0 <= rank < world:
            raise ValueError(f"initialize_multihost: process_id {rank} "
                             f"outside a world of {world}")
        init_method = f"tcp://{coordinator}"
        local_rank = rank % max(torch.cuda.device_count(), 1)
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return 1
        rank = int(os.environ["RANK"])
        init_method = "env://"
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return world


# Mesh-layout note: make_mesh numbers ranks frames-major (rank = frame
# shard * views + view shard), so with ranks enumerated host-major the
# views all_reduce of every iteration stays inside a host on NVLink and
# the frame halos (small, once per call) cross hosts.
