"""Octave Adam driver and the grid styler (counterpart of
``nfs_tpu.styler``)."""
