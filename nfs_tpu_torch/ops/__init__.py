"""Differentiable field and particle operators (counterpart of
``nfs_tpu.ops``)."""
