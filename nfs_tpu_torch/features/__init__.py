"""VGG-19 features and style losses (counterpart of
``nfs_tpu.features``)."""
