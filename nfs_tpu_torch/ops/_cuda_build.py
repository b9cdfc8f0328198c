"""Build and load the port's CUDA libraries (``nfs_tpu_torch/csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``build/nfs_tpu_torch/`` next
to the package. The file name is keyed on a hash of the source and the
flags, so an edited source never loads a stale library. The compile writes
to a temporary file that is renamed into place, so concurrent builders
never load a half-written library. Libraries are loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "nfs_tpu_torch"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def find_nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): the "
        "CUDA kernels of nfs_tpu_torch are built from nfs_tpu_torch/csrc/ "
        "at first use and need the CUDA toolkit")


def library_path(source: Path, stem: str) -> Path:
    """Where the library for ``source`` and the current flags lives."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def build_library(source: Path, stem: str) -> Path:
    """Compile ``source`` unless a library for it already exists."""
    so = library_path(source, stem)
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {source}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


# --------------------------------------------------------------------- #
# what every kernel wrapper checks
# --------------------------------------------------------------------- #

def check_tensor(name: str, t: torch.Tensor, shape, device) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def route(ref: torch.Tensor, what: str) -> str:
    """'plain' for a CPU tensor, 'cuda' for a CUDA tensor; anything else
    raises. There is no fallback from CUDA to the plain version."""
    if ref.device.type == "cpu":
        return "plain"
    if ref.device.type == "cuda":
        return "cuda"
    raise RuntimeError(f"{what} run on cpu or cuda, not {ref.device}")


def raise_on(rc: int, what: str) -> None:
    """Raise on the ``cudaGetLastError()`` code a C entry point returns."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def current_stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
