"""Frame store and image export (counterpart of ``nfs_tpu.io``)."""
