"""CUDA kernels K1-K3 of nfs_tpu_torch against their plain twins, on the
GPU. Every test here needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where only the port and torch
are installed; tests/conftest.py imports JAX, so there run it as
``python -m pytest --noconftest -q tests/test_torch_cuda.py``.

Tolerances: values atol 1e-5, gradients atol 1e-4 (float32 sums of the
same terms in another order; K2's plain twin scatters with atomics).
"""

import numpy as np
import pytest
import torch

from nfs_tpu_torch.ops import advect_kernels as ak
from nfs_tpu_torch.ops.advect import advect

torch.set_num_threads(2)

VALUE_ATOL = 1e-5
GRAD_ATOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(kind, max_disp, shape=(24, 16, 40), seed=0):
    rng = np.random.default_rng(seed)
    f = rng.random(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    v = (max_disp / 1.2816) * rng.standard_normal(shape + (3,),
                                                  dtype=np.float32)
    if kind == "integer":
        v = np.round(v)
    elif kind == "zero":
        v = np.zeros_like(v)
    return f, g, v


@pytest.mark.cuda
@pytest.mark.parametrize("kind,max_disp", [("random", 2.0), ("random", 1.0),
                                           ("integer", 2.0), ("zero", 1.0)])
def test_kernels_match_plain(cuda_device, kind, max_disp):
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs(kind, max_disp))
    before = dict(ak.LAUNCHES)
    torch.testing.assert_close(ak.advect_fwd(f, v, max_disp),
                               ak.advect_fwd_plain(f, v, max_disp),
                               atol=VALUE_ATOL, rtol=0)
    torch.testing.assert_close(ak.advect_bwd_field(v, g, max_disp),
                               ak.advect_bwd_field_plain(v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(ak.advect_bwd_vel(f, v, g, max_disp),
                               ak.advect_bwd_vel_plain(f, v, g, max_disp),
                               atol=GRAD_ATOL, rtol=0)
    assert all(ak.LAUNCHES[k] == before[k] + 1 for k in before)


@pytest.mark.cuda
def test_advect_on_gpu_matches_cpu(cuda_device):
    """The whole autograd path (kernels + clip-gradient chain) on the GPU
    against the same call on the CPU (plain twins)."""
    f, g, v = _inputs("random", 2.0, seed=4)
    outs = {}
    for dev in ("cpu", cuda_device):
        ft = torch.tensor(f, device=dev, requires_grad=True)
        vt = torch.tensor(v, device=dev, requires_grad=True)
        out = advect(ft, vt, max_disp=2.0)
        (out * torch.tensor(g, device=dev)).sum().backward()
        outs[str(dev)] = [t.detach().cpu() for t in (out, ft.grad, vt.grad)]
    cpu, gpu = outs["cpu"], outs[str(cuda_device)]
    torch.testing.assert_close(gpu[0], cpu[0], atol=VALUE_ATOL, rtol=0)
    torch.testing.assert_close(gpu[1], cpu[1], atol=GRAD_ATOL, rtol=0)
    torch.testing.assert_close(gpu[2], cpu[2], atol=GRAD_ATOL, rtol=0)


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda_device):
    f, g, v = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs("random", 2.0))
    with pytest.raises(ValueError):  # field on the GPU, vel on the CPU
        ak.advect_fwd(f, v.cpu(), 2.0)
    with pytest.raises(ValueError):  # not contiguous
        ak.advect_bwd_field(v, g.transpose(0, 2), 2.0)
    with pytest.raises(TypeError):
        ak.advect_bwd_vel(f.half(), v, g, 2.0)
