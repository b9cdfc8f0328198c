"""Octave Adam driver (counterpart of ``nfs_tpu/styler/octave.py``).

``run_octave`` optimizes one tensor, or a dict of tensors, under
``loss_fn(param, views, data) -> scalar``, where ``views`` is that
iteration's camera argument and ``data`` the octave's constants
(densities, VGG weights, Gram targets, view pool). Iterations run eagerly
on the param's device; losses stay there until the caller reads them.
Iterations are grouped in chunks of ``log_every`` when a ``callback``
wants the mean loss of each chunk or a ``state_callback`` checkpoints
{param, Adam state} after each chunk; ``init_opt_state`` and
``start_iter`` resume an octave from such a checkpoint.

:class:`Adam` is ``optax.adam`` written out, over one tensor or a dict of
tensors: moments
``mu = (1-b1) g + b1 mu`` and ``nu = (1-b2) g^2 + b2 nu``, bias
correction by ``1 - b^t``, ``eps`` added AFTER the square root
(``eps_root = 0``), step ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.
``torch.optim.Adam`` is the same algorithm, but the functional form keeps
the state explicit per octave, as the JAX driver does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from nfs_tpu_torch.utils.profiling import span

Param = Union[torch.Tensor, Dict[str, torch.Tensor]]


@dataclass
class AdamState:
    count: int
    mu: Param
    nu: Param


def _leafwise(fn, *trees):
    """fn over the leaves of tensors or of dicts of tensors (same keys)."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Adam:
    """Functional Adam, numerically ``optax.adam(lr, b1, b2, eps)``. The
    parameter is a tensor or a dict of tensors; on a dict the update is
    per leaf and the step count is shared, as optax does over a pytree."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, param: Param) -> AdamState:
        return AdamState(0, _leafwise(torch.zeros_like, param),
                         _leafwise(torch.zeros_like, param))

    def update(self, grad: Param, state: AdamState
               ) -> Tuple[Param, AdamState]:
        b1, b2 = self.b1, self.b2
        mu = _leafwise(lambda g, m: (1 - b1) * g + b1 * m, grad, state.mu)
        nu = _leafwise(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grad,
                       state.nu)
        count = state.count + 1
        # optax computes decay**count in float32
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        updates = _leafwise(
            lambda m, v: -self.lr * ((m / bc1) / (torch.sqrt(v / bc2)
                                                  + self.eps)), mu, nu)
        return updates, AdamState(count, mu, nu)


def run_octave(param: Param, loss_fn: Callable, data,
               views: Sequence, iters: int, lr: float, b1: float = 0.9,
               b2: float = 0.999, log_every: int = 10,
               callback: Callable = None, optimizer: Adam = None,
               init_opt_state: AdamState = None, start_iter: int = 0,
               state_callback: Callable = None
               ) -> Tuple[Param, torch.Tensor, AdamState]:
    """Optimize ``param`` with Adam for ``iters`` steps.

    Args:
      param: the optimization variable, a tensor or a dict of tensors (no
        grad attached).
      loss_fn: (param, views[i], data) -> scalar loss tensor.
      views: per-iteration camera arguments, ``len(views) == iters``.
      callback: optional fn(done, mean_chunk_loss) called after every
        ``log_every`` iterations (and after the last); reading the loss
        synchronises with the device.
      optimizer: an :class:`Adam`; by default one is built from lr/b1/b2.
      init_opt_state: resume Adam from a checkpointed state instead of a
        fresh one.
      start_iter: the first ``start_iter`` iterations count as done (a
        chunk boundary of an earlier run); iteration i still takes
        ``views[i]``, so a resumed octave computes what the
        uninterrupted one did.
      state_callback: optional fn(done, param, adam_state) called after
        each chunk, before ``callback`` (the checkpoint hook: a failing
        logger must not lose the chunk).

    Returns:
      (optimized param, per-iteration losses of the iterations run here
      on the device, final Adam state).
    """
    if len(views) != iters:
        raise ValueError(f"{len(views)} view draws for {iters} iterations")
    opt = optimizer if optimizer is not None else Adam(lr, b1, b2)
    state = (init_opt_state if init_opt_state is not None
             else opt.init(param))
    param = _leafwise(torch.Tensor.detach, param)
    observed = callback is not None or state_callback is not None
    chunk = log_every if observed else iters
    losses = []
    for i in range(start_iter, iters):
        with span("nfs.iter"):
            loss, grad = value_and_grad(loss_fn, param, views[i], data)
            with span("nfs.adam"):
                updates, state = opt.update(grad, state)
                param = _leafwise(lambda p, u: (p + u).detach(), param,
                                  updates)
            losses.append(loss.detach().to(torch.float32))
        done = i + 1
        if observed and (done % chunk == 0 or done == iters):
            if state_callback is not None:
                with span("nfs.checkpoint"):
                    state_callback(done, param, state)
            if callback is not None:
                start = (done - 1) // chunk * chunk - start_iter
                with span("nfs.readback"):
                    mean = float(torch.stack(losses[start:]).mean())
                callback(done, mean)
    device = next(iter(param.values())).device if isinstance(
        param, dict) else param.device
    losses_out = (torch.stack(losses) if losses else
                  torch.zeros((0,), dtype=torch.float32, device=device))
    return param, losses_out, state


def value_and_grad(loss_fn: Callable, param: Param, *args):
    """(loss, gradient of loss wrt every leaf of ``param``) with the
    leaves detached; a leaf the loss does not depend on gets zeros."""
    leaves = (list(param.values()) if isinstance(param, dict)
              else [param])
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    p = (dict(zip(param, leaves)) if isinstance(param, dict)
         else leaves[0])
    loss = loss_fn(p, *args)
    if loss.requires_grad:
        # a vector of independent losses (a keyframe batch's): the
        # gradient of their sum is each one's own
        with span("nfs.backward"):
            grads = torch.autograd.grad(loss.sum() if loss.ndim else loss,
                                        leaves, allow_unused=True)
    else:  # the objective does not depend on the param
        grads = [None] * len(leaves)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return loss, (dict(zip(param, grads)) if isinstance(param, dict)
                  else grads[0])
