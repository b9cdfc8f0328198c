"""Image / video export (reference: ``util.py`` PIL image save + imageio
video assembly, SURVEY.md §2 and §3.5).

Images are float32 arrays in [0, 1], shape (H, W) grayscale or (H, W, 3)
RGB. PIL is optional: without it ``save_image`` writes ``.npy`` files and
``load_image`` reads ``.npy`` images only. Video export degrades to an
image sequence when imageio/ffmpeg is unavailable.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:
    from PIL import Image
    _HAS_PIL = True
except Exception:  # pragma: no cover
    _HAS_PIL = False


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_image(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = _to_uint8(img)
    if _HAS_PIL:
        Image.fromarray(arr).save(path)
    else:  # raw .npy fallback
        np.save(path + ".npy", arr)


def load_image(path: str, size: Optional[tuple] = None,
               grayscale: bool = False) -> np.ndarray:
    """Load an image as float32 [0, 1], (H, W, 3) or (H, W).

    A ``.npy`` file holds the float array itself and needs no PIL; it is
    not resampled, so its (H, W) must already equal ``size``."""
    if path.endswith(".npy"):
        img = np.asarray(np.load(path), dtype=np.float32)
        if grayscale and img.ndim == 3:
            img = img.mean(axis=-1)
        if size is not None and tuple(img.shape[:2]) != tuple(size):
            raise ValueError(f"{path}: image is {img.shape[:2]}, expected "
                             f"{tuple(size)} (.npy images are not resized)")
        return img
    if not _HAS_PIL:
        raise RuntimeError("PIL unavailable; cannot load images")
    img = Image.open(path)
    img = img.convert("L" if grayscale else "RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.BILINEAR)  # PIL is (W,H)
    return np.asarray(img, dtype=np.float32) / 255.0


def save_video(path: str, frames: Sequence[np.ndarray], fps: int = 24) -> None:
    """Write a video if imageio+ffmpeg exist; else a PNG sequence next to
    `path` (reference behavior is imageio/ffmpeg, SURVEY.md §2)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio  # optional

        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(_to_uint8(f))
        return
    except Exception:
        pass
    stem, _ = os.path.splitext(path)
    for i, f in enumerate(frames):
        save_image(f"{stem}_{i:04d}.png", f)
