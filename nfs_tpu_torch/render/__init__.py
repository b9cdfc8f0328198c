"""Camera sampling, the Beer-Lambert and 2D renderers and transfer
functions (counterpart of ``nfs_tpu.render``).

The names ``nfs_tpu.render`` exports are read from their modules at
first use.
"""

from nfs_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "render_volume": ("nfs_tpu_torch.render.raymarch", "render_volume"),
    "render_views": ("nfs_tpu_torch.render.raymarch", "render_views"),
    "render2d": ("nfs_tpu_torch.render.raymarch", "render2d"),
    "poisson_disk_2d": ("nfs_tpu_torch.render.camera", "poisson_disk_2d"),
    "poisson_view_pool": ("nfs_tpu_torch.render.camera", "poisson_view_pool"),
    "sample_views_stratified": ("nfs_tpu_torch.render.camera", "sample_views_stratified"),
    "COLORMAPS": ("nfs_tpu_torch.render.transfer", "COLORMAPS"),
    "resolve_transfer": ("nfs_tpu_torch.render.transfer", "resolve_transfer"),
    "transfer_colors": ("nfs_tpu_torch.render.transfer", "transfer_colors"),
})
