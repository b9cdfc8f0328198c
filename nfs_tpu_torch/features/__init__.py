"""VGG-19 features and style losses (counterpart of
``nfs_tpu.features``).

The names ``nfs_tpu.features`` exports are read from their modules at
first use.
"""

from nfs_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "VGG_LAYERS": ("nfs_tpu_torch.features.vgg", "VGG_LAYERS"),
    "init_vgg_params": ("nfs_tpu_torch.features.vgg", "init_vgg_params"),
    "load_vgg_params": ("nfs_tpu_torch.features.vgg", "load_vgg_params"),
    "save_vgg_params": ("nfs_tpu_torch.features.vgg", "save_vgg_params"),
    "vgg_features": ("nfs_tpu_torch.features.vgg", "vgg_features"),
    "preprocess": ("nfs_tpu_torch.features.vgg", "preprocess"),
    "gram_matrix": ("nfs_tpu_torch.features.losses", "gram_matrix"),
    "style_gram_targets": ("nfs_tpu_torch.features.losses", "style_gram_targets"),
    "style_loss": ("nfs_tpu_torch.features.losses", "style_loss"),
    "semantic_loss": ("nfs_tpu_torch.features.losses", "semantic_loss"),
    "content_loss": ("nfs_tpu_torch.features.losses", "content_loss"),
    "tv_loss": ("nfs_tpu_torch.features.losses", "tv_loss"),
})
