"""nfs_tpu_torch — the PyTorch/CUDA port of ``nfs_tpu``.

The TNST grid path (2D and 3D smoke density, density and velocity
parameterizations, window-transport loss on the bounded-displacement or
the exact advection path, transfer functions, shear or gather rotation,
per-view rematerialization, streaming, fused and block-streamed
sequences with mid-sequence resume, in-frame checkpoints), the LNST
particle path (2D and 3D, position, density and colour attributes,
keyframes), the smoke and FLIP data generators, a spool-directory
stylization service, quality metrics and the joint multi-device
sequence engine of the grid path on PyTorch, with the
bounded-displacement advection kernels and the binned-splat window
kernels written by hand in CUDA for Hopper (``csrc/advect.cu``,
``csrc/binsplat.cu``). The sub-packages mirror
``nfs_tpu``'s so each module's counterpart is found under the same name:

- :mod:`nfs_tpu_torch.core`     — configuration dataclasses, ParticleSet
- :mod:`nfs_tpu_torch.io`       — ``.npz`` frame store, chunked sequence
  cache, ``.uni`` files, in-frame checkpoints, sequence manifest, image
  export
- :mod:`nfs_tpu_torch.ops`      — advection (kernels K1-K3b), splatting and
  binning (kernels K4-K5), grid sampling, resize, shear, gather rotation
- :mod:`nfs_tpu_torch.render`   — Poisson-disk cameras, Beer-Lambert march
  (grey or colour), the 2D renderer, transfer functions
- :mod:`nfs_tpu_torch.features` — VGG-19 features and the losses
- :mod:`nfs_tpu_torch.styler`   — octave Adam driver, ``GridStyler``,
  ``ParticleStyler``
- :mod:`nfs_tpu_torch.sim`      — smoke and FLIP solvers
- :mod:`nfs_tpu_torch.eval`     — quality metrics: temporal coherence and
  its gate, Gram distance and convergence, stylization strength
- :mod:`nfs_tpu_torch.utils`    — profiler traces, device-synchronized
  timers, JSONL metrics, analytic FLOPs and MFU against the H100's peak
- :mod:`nfs_tpu_torch.parallel` — the multi-device layer of the grid
  path on ``torch.distributed``: a (frames, views) mesh of ranks, the
  launcher, ring halos, the sharded window step,
  ``ParallelSequenceStyler``
- :mod:`nfs_tpu_torch.cli`      — stylization (grid, particle), scene
  generation, the stylization service (``cli.serve``) and the renderer
  (``cli.render``)

Public functions keep the JAX package's layouts: volumes ``(D, H, W)``,
velocities ``(D, H, W, 3)`` and particles ``(N, 3)`` in array-axis order,
binned particle arrays slot-minor, images NHWC.

Numerics: float32 work runs in full float32 on the GPU. Building a
styler (``GridStyler``, ``ParticleStyler``) switches TF32 off for
cuDNN convolutions and matmuls (PyTorch enables it for cuDNN by default);
importing the package changes no global setting. The bfloat16 feature
path (``loss.features_dtype='bfloat16'``) casts explicitly instead.

The top-level names ``nfs_tpu`` exports (the configuration classes,
``config_replace``, the stylers and ``ParticleSet``) are read from their
modules at first use, so importing the package imports nothing else.
"""

from nfs_tpu_torch._exports import lazy_exports

__version__ = "0.1.0"

__all__, __getattr__ = lazy_exports(__name__, {
    "StyleConfig": ("nfs_tpu_torch.core.config", "StyleConfig"),
    "DataConfig": ("nfs_tpu_torch.core.config", "DataConfig"),
    "RenderConfig": ("nfs_tpu_torch.core.config", "RenderConfig"),
    "LossConfig": ("nfs_tpu_torch.core.config", "LossConfig"),
    "OptimConfig": ("nfs_tpu_torch.core.config", "OptimConfig"),
    "ParticleConfig": ("nfs_tpu_torch.core.config", "ParticleConfig"),
    "ParallelConfig": ("nfs_tpu_torch.core.config", "ParallelConfig"),
    "config_replace": ("nfs_tpu_torch.core.config", "replace"),
    "GridStyler": ("nfs_tpu_torch.styler.grid", "GridStyler"),
    "ParticleStyler": ("nfs_tpu_torch.styler.particle", "ParticleStyler"),
    "ParallelSequenceStyler": ("nfs_tpu_torch.parallel.engine", "ParallelSequenceStyler"),
    "ParticleSet": ("nfs_tpu_torch.core.pytrees", "ParticleSet"),
})
