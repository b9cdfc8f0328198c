"""Octave Adam driver (counterpart of ``nfs_tpu/styler/octave.py``).

``run_octave`` optimizes one tensor under
``loss_fn(param, views, data) -> scalar``, where ``views`` is that
iteration's camera argument and ``data`` the octave's constants
(densities, VGG weights, Gram targets, view pool). Iterations run eagerly
on the param's device; losses stay there until the caller reads them.
Iterations are grouped in chunks of ``log_every`` when a ``callback``
wants the mean loss of each chunk.

:class:`Adam` is ``optax.adam`` written out: moments
``mu = (1-b1) g + b1 mu`` and ``nu = (1-b2) g^2 + b2 nu``, bias
correction by ``1 - b^t``, ``eps`` added AFTER the square root
(``eps_root = 0``), step ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.
``torch.optim.Adam`` is the same algorithm, but the functional form keeps
the state explicit per octave, as the JAX driver does.

Checkpointed state (``state_callback``) and mid-octave resume wait for
ROADMAP queue 1, item 16.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np
import torch


@dataclass
class AdamState:
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class Adam:
    """Functional Adam, numerically ``optax.adam(lr, b1, b2, eps)``."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, param: torch.Tensor) -> AdamState:
        return AdamState(0, torch.zeros_like(param),
                         torch.zeros_like(param))

    def update(self, grad: torch.Tensor, state: AdamState
               ) -> Tuple[torch.Tensor, AdamState]:
        b1, b2 = self.b1, self.b2
        mu = (1 - b1) * grad + b1 * state.mu
        nu = (1 - b2) * grad ** 2 + b2 * state.nu
        count = state.count + 1
        # optax computes decay**count in float32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return -self.lr * step, AdamState(count, mu, nu)


def run_octave(param: torch.Tensor, loss_fn: Callable, data,
               views: Sequence, iters: int, lr: float, b1: float = 0.9,
               b2: float = 0.999, log_every: int = 10,
               callback: Callable = None, optimizer: Adam = None
               ) -> Tuple[torch.Tensor, torch.Tensor, AdamState]:
    """Optimize ``param`` with Adam for ``iters`` steps.

    Args:
      param: the optimization variable (no grad attached).
      loss_fn: (param, views[i], data) -> scalar loss tensor.
      views: per-iteration camera arguments, ``len(views) == iters``.
      callback: optional fn(done, mean_chunk_loss) called after every
        ``log_every`` iterations (and after the last); reading the loss
        synchronises with the device.
      optimizer: an :class:`Adam`; by default one is built from lr/b1/b2.

    Returns:
      (optimized param, per-iteration losses (iters,) on the device,
      final Adam state).
    """
    if len(views) != iters:
        raise ValueError(f"{len(views)} view draws for {iters} iterations")
    opt = optimizer if optimizer is not None else Adam(lr, b1, b2)
    state = opt.init(param)
    param = param.detach()
    chunk = log_every if callback is not None else iters
    losses = []
    for i in range(iters):
        p = param.requires_grad_(True)
        loss = loss_fn(p, views[i], data)
        if loss.requires_grad:
            (grad,) = torch.autograd.grad(loss, p)
        else:  # the objective does not depend on the param
            grad = torch.zeros_like(p)
        updates, state = opt.update(grad, state)
        param = (p.detach() + updates).detach()
        losses.append(loss.detach().to(torch.float32).reshape(()))
        done = i + 1
        if callback is not None and (done % chunk == 0 or done == iters):
            start = (done - 1) // chunk * chunk
            callback(done, float(torch.stack(losses[start:]).mean()))
    losses_out = (torch.stack(losses) if losses else
                  torch.zeros((0,), dtype=torch.float32,
                              device=param.device))
    return param, losses_out, state
