"""Build and load the port's CUDA kernels (``nfs_tpu_torch/csrc/``) and
the PyTorch operators through which every kernel wrapper launches them.

Each kernel source (``advect.cu``, ``binsplat.cu``) is compiled with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface;
``ops.cpp`` is compiled with the host compiler against torch's headers
and linked to both into the operator library, which registers
``torch.ops.nfs_tpu_torch.*`` when :func:`load_operators` loads it. The
three compiles start together, at first use, into ``build/nfs_tpu_torch/``
next to the package. Each file name is keyed on a hash of what it is
built from (the source, the headers beside it, the flags, and for the
operators torch's version and the kernel libraries' names), so an edited
source never loads a stale library. Each compile writes to a temporary
file that is renamed into place, so concurrent builders never load a
half-written library.

On a CUDA tensor a wrapper calls its operator, which checks the tensors,
allocates the outputs and launches on the device's current stream in
C++; the C entry point makes the device current only when it is not
already. On a CPU tensor the wrapper makes the same checks with
:func:`check` and runs its plain version. PERF.md gives what each piece
of a launch costs through the operators and through ``ctypes``.
"""

from __future__ import annotations

import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
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
# the operators' compile (torch's headers need C++20)
CXX_FLAGS: List[str] = ["-std=c++20", "-O2", "-fPIC"]
KERNEL_SOURCES = (("advect.cu", "nfs_advect"),
                  ("binsplat.cu", "nfs_binsplat"))


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


def find_cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError(
            "no host C++ compiler ($CXX or g++): the operators of "
            "nfs_tpu_torch (csrc/ops.cpp) are built at first use")
    return cxx


def _key(*parts: bytes) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.hexdigest()[:16]


def library_path(source: Path, stem: str) -> Path:
    """Where the library for ``source``, the headers beside it and the
    current flags lives."""
    source = Path(source)
    headers = [h.read_bytes() for h in sorted(source.parent.glob("*.cuh"))]
    key = _key(source.read_bytes(), *headers, " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}_{key}.so"


def _compile(cmd: List[str], out: Path, what: str) -> Path:
    """Run the compile ``cmd`` (writing the file named by its last
    argument) into a temporary file renamed to ``out``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{Path(cmd[0]).name} failed "
                               f"({proc.returncode}) on {what}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_library(source: Path, stem: str) -> Path:
    """Compile ``source`` with nvcc unless its library already exists."""
    so = library_path(source, stem)
    if not so.exists():
        _compile([find_nvcc(), *NVCC_FLAGS, str(source), "-o"], so,
                 str(source))
    return so


def _torch_dirs():
    root = Path(torch.__file__).resolve().parent
    return root / "include", root / "lib"


def _operator_object() -> Path:
    """Compile ops.cpp against torch's headers unless its object exists."""
    source = CSRC / "ops.cpp"
    flags = [*CXX_FLAGS, "-D_GLIBCXX_USE_CXX11_ABI="
             f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    key = _key(source.read_bytes(), " ".join(flags).encode(),
               torch.__version__.encode())
    obj = BUILD_DIR / f"nfs_ops_{key}.o"
    if not obj.exists():
        include, _ = _torch_dirs()
        _compile([find_cxx(), *flags, f"-I{include}", "-c", str(source),
                  "-o"], obj, str(source))
    return obj


def build_operators() -> Path:
    """Build the two kernel libraries and the operator library, the
    three compiles started together, and link the operators to the
    kernels (found beside them at load time); returns the operator
    library. Raises RuntimeError when a compiler is missing or fails."""
    find_nvcc(), find_cxx()     # before any compile starts
    with ThreadPoolExecutor(3) as pool:
        libs = [pool.submit(build_library, CSRC / src, stem)
                for src, stem in KERNEL_SOURCES]
        obj = pool.submit(_operator_object)
        libs = [f.result() for f in libs]
        obj = obj.result()
    key = _key(obj.name.encode(), *(so.name.encode() for so in libs))
    ops = BUILD_DIR / f"libnfs_ops_{key}.so"
    if not ops.exists():
        _, torch_lib = _torch_dirs()
        _compile([find_cxx(), "-shared", str(obj),
                  *(f"-l:{so.name}" for so in libs), f"-L{BUILD_DIR}",
                  "-Wl,-rpath,$ORIGIN", f"-L{torch_lib}", "-lc10",
                  "-ltorch_cpu", f"-Wl,-rpath,{torch_lib}", "-o"], ops,
                 "the operator library")
    return ops


@functools.lru_cache(maxsize=None)
def load_operators():
    """Build (first use) and load the operators; returns the namespace
    ``torch.ops.nfs_tpu_torch``. Raises RuntimeError when they cannot be
    built."""
    torch.ops.load_library(str(build_operators()))
    return torch.ops.nfs_tpu_torch


# --------------------------------------------------------------------- #
# what every kernel wrapper checks on CPU tensors
# --------------------------------------------------------------------- #

F32 = torch.float32


def check(what: str, names, tensors, shapes, dtypes=None) -> None:
    """Every check of a kernel wrapper on CPU tensors, in one pass over
    its ``tensors``, as its operator makes them on CUDA tensors:
    TypeError unless each has its dtype (``dtypes``, float32 where not
    given), ValueError unless each has its shape (``shapes``), lies on
    the first tensor's device and is contiguous, raised for the first
    failure in the order of ``names`` and of those four checks;
    RuntimeError unless that device is the CPU. There is no fallback
    from CUDA to the plain version."""
    first = tensors[0]
    dev = first.device
    dtypes = dtypes or (F32,) * len(tensors)
    for t, shape, dtype in zip(tensors, shapes, dtypes):
        if (t.dtype is not dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            _refuse(names, tensors, shapes, dtypes, dev)
    if not first.is_cpu:
        raise RuntimeError(f"{what} run on cpu or cuda, not {dev}")


def _refuse(names, tensors, shapes, dtypes, dev) -> None:
    for name, t, shape, dtype in zip(names, tensors, shapes, dtypes):
        if t.dtype is not dtype:
            expected = str(dtype).removeprefix("torch.")
            raise TypeError(f"{name}: expected {expected}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name}: on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
