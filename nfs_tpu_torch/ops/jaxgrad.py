"""Elementwise functions whose gradients are JAX's subgradients at the
kinks, where torch's own ``abs``, ``clamp`` and ``maximum`` choose
otherwise. The port's parity with the JAX package depends on them: smoke
densities sit exactly at 0 in much of a volume, and clamped coordinates
sit exactly at a bound."""

from __future__ import annotations

import torch

from nfs_tpu_torch.ops.advect_kernels import _clip_grad, _dtent, _tent


class _Tent(torch.autograd.Function):
    """max(0, 1 - |u|) with JAX's subgradient (pallas_advect.py _dtent)."""

    @staticmethod
    def forward(ctx, u):
        ctx.save_for_backward(u)
        return _tent(u)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return g * _dtent(u)


class _Clip(torch.autograd.Function):
    """clip(x, lo, hi) whose gradient is 0.5 at a bound, as jnp.clip's."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return x.clamp(lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _clip_grad(x, *ctx.bounds), None, None


class _Maximum(torch.autograd.Function):
    """max(x, c) for a constant c whose gradient is 0.5 at a tie, as
    jnp.maximum's (torch's clamp gives 1)."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.save_for_backward(x)
        ctx.c = c
        return torch.clamp(x, min=c)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = torch.where(x > ctx.c, 1.0, torch.where(x == ctx.c, 0.5, 0.0))
        return g * w, None


def jax_tent(u: torch.Tensor) -> torch.Tensor:
    return _Tent.apply(u)


def jax_clip(x: torch.Tensor, lo: float, hi) -> torch.Tensor:
    return _Clip.apply(x, lo, hi)


def jax_maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    return _Maximum.apply(x, c)
