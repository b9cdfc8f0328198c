"""Frame store, chunked sequence cache, ``.uni`` files, sequence manifest
and image export (counterpart of ``nfs_tpu.io``)."""
