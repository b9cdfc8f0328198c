"""Quality evaluation (counterpart of ``nfs_tpu/eval``): temporal
coherence, Gram distance and convergence, stylization strength. The
package exports what ``nfs_tpu.eval`` does; the coherence gate is in
:mod:`.quality`, as there."""

from nfs_tpu_torch.eval.quality import (  # noqa: F401
    gram_convergence,
    gram_distance,
    stylization_strength,
    temporal_coherence,
)

__all__ = [
    "gram_convergence",
    "gram_distance",
    "stylization_strength",
    "temporal_coherence",
]
