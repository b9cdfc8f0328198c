"""Configuration dataclasses (counterpart of ``nfs_tpu.core``)."""

from nfs_tpu_torch.core.config import (
    DataConfig, LossConfig, OptimConfig, ParallelConfig, ParticleConfig,
    RenderConfig, StyleConfig,
)

__all__ = [
    "StyleConfig", "DataConfig", "RenderConfig", "LossConfig",
    "OptimConfig", "ParallelConfig", "ParticleConfig",
]
