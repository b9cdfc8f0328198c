"""Particle container (counterpart of ``nfs_tpu/core/pytrees.py``).

Conventions, as in the JAX package: *particles* are ``(N, dim)`` positions
in cell-index coordinates, in array-axis order, with optional
per-particle attributes. The JAX class is a registered pytree; here it is
a plain dataclass of tensors (or arrays, before they reach a device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ParticleSet:
    """A particle system (LNST §4).

    x     : (N, dim) positions, cell-index coordinates (axis order).
    dens  : (N,) per-particle density weights (optional; ones if None).
    color : (N, 3) per-particle color (optional).
    vel   : (N, dim) particle velocities (optional, FLIP).
    """

    x: torch.Tensor
    dens: Optional[torch.Tensor] = None
    color: Optional[torch.Tensor] = None
    vel: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[-1]
