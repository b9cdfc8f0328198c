"""Command-line entry points (counterpart of ``nfs_tpu.cli``)."""
