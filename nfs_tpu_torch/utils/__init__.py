"""Observability (counterpart of ``nfs_tpu/utils``): profiler traces,
device-synchronized iteration timing, structured metrics, and the
analytic FLOP count of a styler step (:mod:`nfs_tpu_torch.utils.flops`)."""

from nfs_tpu_torch.utils.metrics import MetricsLogger
from nfs_tpu_torch.utils.profiling import IterationTimer, timed, trace

__all__ = ["trace", "IterationTimer", "timed", "MetricsLogger"]
