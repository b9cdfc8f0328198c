"""Configuration dataclasses and the particle container (counterpart of
``nfs_tpu.core``)."""

from nfs_tpu_torch.core.config import (
    DataConfig, LossConfig, OptimConfig, ParallelConfig, ParticleConfig,
    RenderConfig, StyleConfig,
)
from nfs_tpu_torch.core.pytrees import ParticleSet

__all__ = [
    "StyleConfig", "DataConfig", "RenderConfig", "LossConfig",
    "OptimConfig", "ParallelConfig", "ParticleConfig", "ParticleSet",
]
