"""Frame store, chunked sequence cache, ``.uni`` files, in-frame
checkpoints, sequence manifest and image export (counterpart of
``nfs_tpu.io``).

The names ``nfs_tpu.io`` exports are read from their modules at first
use; the particle codecs (``read_uni_particles``, ``write_uni_particles``,
``read_uni_pdata``, ``write_uni_pdata``) are in :mod:`.uni`, as there.
"""

from nfs_tpu_torch._exports import lazy_exports

__all__, __getattr__ = lazy_exports(__name__, {
    "FrameStore": ("nfs_tpu_torch.io.npz", "FrameStore"),
    "load_frame": ("nfs_tpu_torch.io.npz", "load_frame"),
    "save_frame": ("nfs_tpu_torch.io.npz", "save_frame"),
    "read_uni": ("nfs_tpu_torch.io.uni", "read_uni"),
    "write_uni": ("nfs_tpu_torch.io.uni", "write_uni"),
    "load_image": ("nfs_tpu_torch.io.image", "load_image"),
    "save_image": ("nfs_tpu_torch.io.image", "save_image"),
    "save_video": ("nfs_tpu_torch.io.image", "save_video"),
})
