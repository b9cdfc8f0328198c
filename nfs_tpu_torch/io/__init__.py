"""Frame store, chunked sequence cache, ``.uni`` files, in-frame
checkpoints, sequence manifest and image export (counterpart of
``nfs_tpu.io``)."""
