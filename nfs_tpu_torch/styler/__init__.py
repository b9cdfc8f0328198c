"""Octave Adam driver and the grid and particle stylers (counterpart of
``nfs_tpu.styler``).

The names ``nfs_tpu.styler`` exports are read from their modules at
first use.
"""

from nfs_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "run_octave": ("nfs_tpu_torch.styler.octave", "run_octave"),
    "GridStyler": ("nfs_tpu_torch.styler.grid", "GridStyler"),
    "ParticleStyler": ("nfs_tpu_torch.styler.particle", "ParticleStyler"),
})
