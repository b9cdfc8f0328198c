"""Differentiable field operators (counterpart of ``nfs_tpu.ops``)."""
