"""Camera sampling, the Beer-Lambert and 2D renderers and transfer
functions (counterpart of ``nfs_tpu.render``)."""
