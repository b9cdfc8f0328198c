"""Camera sampling and the Beer-Lambert renderer (counterpart of
``nfs_tpu.render``)."""
