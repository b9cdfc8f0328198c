"""nfs_tpu_torch — the PyTorch/CUDA port of ``nfs_tpu``.

The TNST grid path (3D smoke density, density and velocity
parameterizations, window-transport loss, streaming sequences) on PyTorch,
with the bounded-displacement advection kernels written by hand in CUDA
for Hopper (``csrc/advect.cu``). The sub-packages mirror ``nfs_tpu``'s so
each module's counterpart is found under the same name:

- :mod:`nfs_tpu_torch.core`     — configuration dataclasses
- :mod:`nfs_tpu_torch.io`       — ``.npz`` frame store, image export
- :mod:`nfs_tpu_torch.ops`      — advection (kernels K1-K3), resize, shear
- :mod:`nfs_tpu_torch.render`   — Poisson-disk cameras, Beer-Lambert march
- :mod:`nfs_tpu_torch.features` — VGG-19 features and the losses
- :mod:`nfs_tpu_torch.styler`   — octave Adam driver and ``GridStyler``
- :mod:`nfs_tpu_torch.cli`      — grid-mode stylization entry point

Public functions keep the JAX package's layouts: volumes ``(D, H, W)``,
velocities ``(D, H, W, 3)`` in array-axis order, images NHWC.

Numerics: float32 work runs in full float32 on the GPU. Building a
:class:`~nfs_tpu_torch.styler.grid.GridStyler` switches TF32 off for
cuDNN convolutions and matmuls (PyTorch enables it for cuDNN by default);
importing the package changes no global setting. The bfloat16 feature
path (``loss.features_dtype='bfloat16'``) casts explicitly instead.
"""

__version__ = "0.1.0"
