"""Octave Adam driver and the grid and particle stylers (counterpart of
``nfs_tpu.styler``)."""
