"""Bounded-displacement advection kernels K1-K3 and their plain twins.

Counterpart of ``nfs_tpu/ops/pallas_advect.py``. Three CUDA kernels in
``nfs_tpu_torch/csrc/advect.cu`` replace its three split Pallas kernels:

=========  ==========================================  ===================
launch     CUDA kernel (advect.cu)                     replaces
=========  ==========================================  ===================
fwd        ``advect_fwd_kernel``        (K1)           ``_fwd_kernel``
bwd_field  ``advect_bwd_field_kernel``  (K2)           ``_bwd_field_kernel``
bwd_vel    ``advect_bwd_vel_kernel``    (K3)           ``_bwd_vel_kernel``
=========  ==========================================  ===================

Each wrapper (:func:`advect_fwd`, :func:`advect_bwd_field`,
:func:`advect_bwd_vel`) takes f32 contiguous tensors: a ``(D, H, W)``
field or cotangent and a ``(D, H, W, 3)`` displacement (velocity already
multiplied by ``dt``) in array-axis channel order. On a CPU tensor it
runs its plain PyTorch twin (``*_plain``); on a CUDA tensor it launches
the kernel and counts the launch in :data:`LAUNCHES`, or raises. There
is no fallback from CUDA to the plain twin.

The TPU kernels evaluate every tap of the (2K+1)^3 window from VMEM
because a gather is slow on the TPU. On Hopper a gather through L1 is
cheap, so the kernels visit only the taps whose weight can be nonzero
(8 for K1, 27 for K3, (2R+1)^3 source cells for K2 with
R = ceil(max_disp)); the result equals the window sum. What bounds each
kernel on the H100 and what the design does about it is noted in
``advect.cu``.

The library is built with ``nvcc`` for ``sm_90a`` from the repository's
own source at first use into ``build/nfs_tpu_torch/`` next to the
package, under a file name keyed on a hash of the source and flags, and
loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

import torch

# Launch counts of the CUDA kernels; each wrapper adds one where it
# launches, and nowhere else.
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd_field": 0, "bwd_vel": 0}

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "advect.cu"
BUILD_DIR = _PKG.parent / "build" / "nfs_tpu_torch"
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------- #
# build + load
# --------------------------------------------------------------------- #

def _find_nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): the "
        "CUDA advection kernels are built from nfs_tpu_torch/csrc/advect.cu "
        "at first use and need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnfs_advect_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile advect.cu unless a library for this source already exists.
    The compile writes to a temporary file that is renamed into place, so
    concurrent builders never load a half-written library."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; raises RuntimeError
    when it cannot be built."""
    lib = ctypes.CDLL(str(build_library()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nfs_advect_fwd.argtypes = [p, p, p, i, i, i, f, p]
    lib.nfs_advect_bwd_field.argtypes = [p, p, p, i, i, i, f, i, p]
    lib.nfs_advect_bwd_vel.argtypes = [p, p, p, p, i, i, i, f, p]
    for fn in (lib.nfs_advect_fwd, lib.nfs_advect_bwd_field,
               lib.nfs_advect_bwd_vel):
        fn.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------- #
# shared math (plain twins and the gradient chain)
# --------------------------------------------------------------------- #

def _tent(u: torch.Tensor) -> torch.Tensor:
    """max(0, 1 - |u|) (pallas_advect.py _tent)."""
    return torch.clamp(1.0 - u.abs(), min=0.0)


def _dtent(u: torch.Tensor) -> torch.Tensor:
    """d/du tent with JAX's subgradients: abs'(0) = +1, 0.5 at |u| == 1
    (pallas_advect.py _dtent)."""
    sgn = torch.where(u >= 0.0, 1.0, -1.0)
    au = u.abs()
    mag = torch.where(au < 1.0, 1.0, torch.where(au == 1.0, 0.5, 0.0))
    return -sgn * mag


def _axes(shape, device):
    """Per-axis float index tensors broadcastable against (D, H, W)."""
    D, H, W = shape
    f32 = torch.float32
    return (torch.arange(D, dtype=f32, device=device).view(D, 1, 1),
            torch.arange(H, dtype=f32, device=device).view(1, H, 1),
            torch.arange(W, dtype=f32, device=device).view(1, 1, W))


def backtrace(vel: torch.Tensor, max_disp: float):
    """Clamped backtrace coordinates (s_z, s_y, s_x), each (D, H, W)."""
    shape = vel.shape[:3]
    disp = vel.clamp(-max_disp, max_disp)
    idx = _axes(shape, vel.device)
    return [(idx[a] - disp[..., a]).clamp(0.0, shape[a] - 1)
            for a in range(3)]


def _clip_grad(x, lo, hi):
    """JAX's clip subgradient: 1 strictly inside, 0 outside, 0.5 at a
    bound (pallas_advect.py:495)."""
    inside = ((x > lo) & (x < hi)).to(torch.float32)
    at_edge = ((x == lo) | (x == hi)).to(torch.float32)
    return inside + 0.5 * at_edge


def vel_grad_chain(grad_s: torch.Tensor, vel: torch.Tensor,
                   max_disp: float) -> torch.Tensor:
    """grad wrt the displacement from grad wrt s = clip(i - clip(v)):
    ``-grad_s * outer * inner`` (pallas_advect.py:492-508, dt = 1)."""
    D, H, W = vel.shape[:3]
    idx = torch.stack(torch.broadcast_tensors(*_axes((D, H, W), vel.device)),
                      dim=-1)
    sizes = torch.tensor([D - 1, H - 1, W - 1], dtype=torch.float32,
                         device=vel.device)
    v = vel.to(torch.float32)
    outer = _clip_grad(idx - v.clamp(-max_disp, max_disp), 0.0, sizes)
    inner = _clip_grad(v, -max_disp, max_disp)
    return -grad_s * outer * inner


def _corner(s, c, n):
    """Tap c (float tensor of integer values) along an axis of size n:
    (clamped long index, tent weight with out-of-grid taps zeroed)."""
    ok = (c >= 0) & (c <= n - 1)
    w = torch.where(ok, _tent(s - c), 0.0)
    return c.clamp(0, n - 1).long(), w, ok


def advect_fwd_plain(field: torch.Tensor, vel: torch.Tensor,
                     max_disp: float) -> torch.Tensor:
    """K1 on tensors: trilinear sample at s over the 8 corners, corners
    outside the grid reading 0."""
    D, H, W = field.shape
    s = backtrace(vel, max_disp)
    base = [torch.floor(x) for x in s]
    flat = field.reshape(-1)
    out = torch.zeros_like(field)
    for cz in (0, 1):
        iz, wz, _ = _corner(s[0], base[0] + cz, D)
        for cy in (0, 1):
            iy, wy, _ = _corner(s[1], base[1] + cy, H)
            for cx in (0, 1):
                ix, wx, _ = _corner(s[2], base[2] + cx, W)
                out = out + wz * wy * wx * flat[(iz * H + iy) * W + ix]
    return out


def advect_bwd_field_plain(vel: torch.Tensor, g: torch.Tensor,
                           max_disp: float) -> torch.Tensor:
    """K2 on tensors: the adjoint of K1, scattered with ``index_add_``
    over the 8 corners of every source cell."""
    D, H, W = g.shape
    s = backtrace(vel, max_disp)
    base = [torch.floor(x) for x in s]
    out = torch.zeros(D * H * W, dtype=torch.float32, device=g.device)
    for cz in (0, 1):
        iz, wz, _ = _corner(s[0], base[0] + cz, D)
        for cy in (0, 1):
            iy, wy, _ = _corner(s[1], base[1] + cy, H)
            for cx in (0, 1):
                ix, wx, _ = _corner(s[2], base[2] + cx, W)
                lin = ((iz * H + iy) * W + ix).reshape(-1)
                out.index_add_(0, lin, (wz * wy * wx * g).reshape(-1))
    return out.view(D, H, W)


def advect_bwd_vel_plain(field: torch.Tensor, vel: torch.Tensor,
                         g: torch.Tensor, max_disp: float) -> torch.Tensor:
    """K3 on tensors: (D, H, W, 3) grad wrt s over the 27 taps
    floor(s)-1 .. floor(s)+1 per axis (the tap at floor(s)+2 always has
    |u| > 1). At an integer s this keeps the three-tap subgradient
    (dtent(0) = -1, dtent(+-1) = -+0.5) that a floor-based 2-corner
    gradient would miss."""
    D, H, W = field.shape
    dims = (D, H, W)
    s = backtrace(vel, max_disp)
    flat = field.reshape(-1)
    taps = []
    for a in range(3):
        base = torch.floor(s[a]) - 1.0
        row = []
        for t in range(3):
            c = base + t
            idx, w, ok = _corner(s[a], c, dims[a])
            d = torch.where(ok, _dtent(s[a] - c), 0.0)
            row.append((idx, w, d))
        taps.append(row)
    az = torch.zeros_like(field)
    ay = torch.zeros_like(field)
    ax = torch.zeros_like(field)
    for iz, wz, dz in taps[0]:
        for iy, wy, dy in taps[1]:
            for ix, wx, dx in taps[2]:
                f = flat[(iz * H + iy) * W + ix]
                az = az + dz * wy * wx * f
                ay = ay + wz * dy * wx * f
                ax = ax + wz * wy * dx * f
    return torch.stack([az * g, ay * g, ax * g], dim=-1)


# --------------------------------------------------------------------- #
# wrappers: plain twin on CPU tensors, CUDA kernel on CUDA tensors
# --------------------------------------------------------------------- #

def _check(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(ref: torch.Tensor) -> str:
    if ref.device.type == "cpu":
        return "plain"
    if ref.device.type == "cuda":
        return "cuda"
    raise RuntimeError(f"advection kernels run on cpu or cuda, not "
                       f"{ref.device}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def advect_fwd(field: torch.Tensor, vel: torch.Tensor,
               max_disp: float) -> torch.Tensor:
    """K1: advected field (D, H, W)."""
    D, H, W = field.shape
    _check("field", field, (D, H, W), field.device)
    _check("vel", vel, (D, H, W, 3), field.device)
    if _route(field) == "plain":
        return advect_fwd_plain(field, vel, max_disp)
    lib = load_library()
    out = torch.empty_like(field)
    with torch.cuda.device(field.device):
        rc = lib.nfs_advect_fwd(field.data_ptr(), vel.data_ptr(),
                                out.data_ptr(), D, H, W, float(max_disp),
                                _stream(field.device))
    _raise_on(rc, "advect_fwd")
    LAUNCHES["fwd"] += 1
    return out


def advect_bwd_field(vel: torch.Tensor, g: torch.Tensor,
                     max_disp: float) -> torch.Tensor:
    """K2: gradient wrt the advected field, (D, H, W)."""
    D, H, W = g.shape
    _check("g", g, (D, H, W), g.device)
    _check("vel", vel, (D, H, W, 3), g.device)
    if _route(g) == "plain":
        return advect_bwd_field_plain(vel, g, max_disp)
    lib = load_library()
    out = torch.empty_like(g)
    # source-cell radius: a source i with |i_a - j_a| > ceil(max_disp)
    # backtraces to |s_a - j_a| >= 1, where the tent weight is 0
    radius = int(math.ceil(max_disp))
    with torch.cuda.device(g.device):
        rc = lib.nfs_advect_bwd_field(vel.data_ptr(), g.data_ptr(),
                                      out.data_ptr(), D, H, W,
                                      float(max_disp), radius,
                                      _stream(g.device))
    _raise_on(rc, "advect_bwd_field")
    LAUNCHES["bwd_field"] += 1
    return out


def advect_bwd_vel(field: torch.Tensor, vel: torch.Tensor,
                   g: torch.Tensor, max_disp: float) -> torch.Tensor:
    """K3: gradient wrt the backtrace coordinates s, (D, H, W, 3)."""
    D, H, W = field.shape
    _check("field", field, (D, H, W), field.device)
    _check("vel", vel, (D, H, W, 3), field.device)
    _check("g", g, (D, H, W), field.device)
    if _route(field) == "plain":
        return advect_bwd_vel_plain(field, vel, g, max_disp)
    lib = load_library()
    out = torch.empty_like(vel)
    with torch.cuda.device(field.device):
        rc = lib.nfs_advect_bwd_vel(field.data_ptr(), vel.data_ptr(),
                                    g.data_ptr(), out.data_ptr(), D, H, W,
                                    float(max_disp), _stream(field.device))
    _raise_on(rc, "advect_bwd_vel")
    LAUNCHES["bwd_vel"] += 1
    return out


class AdvectWindow(torch.autograd.Function):
    """Differentiable bounded-displacement advection of a 3D scalar field
    with a clamp boundary: ``AdvectWindow.apply(field, vel_times_dt,
    max_disp)``. Counterpart of ``advect_pallas``' custom VJP. The
    backward runs K2 only when the field needs a gradient and K3 only
    when the displacement does."""

    @staticmethod
    def forward(ctx, field, vel, max_disp):
        field = field.contiguous()
        vel = vel.contiguous()
        ctx.save_for_backward(field, vel)
        ctx.max_disp = float(max_disp)
        return advect_fwd(field, vel, ctx.max_disp)

    @staticmethod
    def backward(ctx, g):
        field, vel = ctx.saved_tensors
        g = g.contiguous()
        grad_field = grad_vel = None
        if ctx.needs_input_grad[0]:
            grad_field = advect_bwd_field(vel, g, ctx.max_disp)
        if ctx.needs_input_grad[1]:
            grad_s = advect_bwd_vel(field, vel, g, ctx.max_disp)
            grad_vel = vel_grad_chain(grad_s, vel, ctx.max_disp)
        return grad_field, grad_vel, None
