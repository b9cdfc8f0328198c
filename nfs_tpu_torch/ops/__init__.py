"""Differentiable field and particle operators (counterpart of
``nfs_tpu.ops``).

The names ``nfs_tpu.ops`` exports are imported here, as there: four of
them (``advect``, ``resize``, ``shear``, ``splat``) share their name with
the submodule that defines them, and a lazy ``__getattr__`` would give
back the submodule once it has been imported. The ops modules import
only torch, numpy and each other, so this starts no cycle. The port's
batch forms have names of their own and stay in their modules:
``rotate3d_shear_volumes`` (:mod:`.shear`), ``rotate3d_batch``
(:mod:`.rotate`), ``advect_frames`` (:mod:`.advect`).
"""

from nfs_tpu_torch.ops.interp import grid_sample
from nfs_tpu_torch.ops.advect import advect, advect_maccormack
from nfs_tpu_torch.ops.rotate import rotate3d, rotation_matrix
from nfs_tpu_torch.ops.shear import rotate3d_shear, shear
from nfs_tpu_torch.ops.resize import resize, octave_shapes, octave_shape
from nfs_tpu_torch.ops.splat import splat, splat_normalized

__all__ = [
    "grid_sample",
    "advect",
    "advect_maccormack",
    "rotate3d",
    "rotation_matrix",
    "rotate3d_shear",
    "shear",
    "resize",
    "octave_shapes",
    "octave_shape",
    "splat",
    "splat_normalized",
]
