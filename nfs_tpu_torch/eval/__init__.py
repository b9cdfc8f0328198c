"""Quality evaluation (counterpart of ``nfs_tpu/eval``): temporal
coherence, Gram distance and convergence, stylization strength."""

from nfs_tpu_torch.eval.quality import (  # noqa: F401
    coherence_gate,
    gram_convergence,
    gram_distance,
    stylization_strength,
    temporal_coherence,
)

__all__ = [
    "coherence_gate",
    "gram_convergence",
    "gram_distance",
    "stylization_strength",
    "temporal_coherence",
]
