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

:class:`_OctaveGraphs` runs the same octave on a GPU as CUDA graphs: one
Adam iteration (loss, backward, Adam, parameter add) is captured once per
key and replayed for every iteration after, so that an iteration costs
the host one graph launch where the eager loop launches each kernel. The
same kernels run in the same order on the same data, so the bits are the
eager loop's. The grid styler's sequence paths use it (``styler/grid.py``
``_sweep``); every other caller runs :func:`run_octave`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Sequence, Tuple, Union

import numpy as np
import torch

from nfs_tpu_torch.ops import advect_kernels, binsplat_kernels
from nfs_tpu_torch.utils.profiling import span

Param = Union[torch.Tensor, Dict[str, torch.Tensor]]

# the hand kernels' launch counters, which a replayed octave adds to
_LAUNCH_COUNTERS = (advect_kernels.LAUNCHES, binsplat_kernels.LAUNCHES)


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
        bc1, bc2 = self._corrections(count)
        updates = _leafwise(
            lambda m, v: -self.lr * ((m / bc1) / (torch.sqrt(v / bc2)
                                                  + self.eps)), mu, nu)
        return updates, AdamState(count, mu, nu)

    def _corrections(self, count: int) -> Tuple[float, float]:
        """The bias corrections ``1 - b1^count`` and ``1 - b2^count``
        (optax computes decay**count in float32)."""
        one = np.float32(1)
        return (float(one - np.float32(self.b1) ** np.float32(count)),
                float(one - np.float32(self.b2) ** np.float32(count)))

    def _step_in_place(self, grad: Param, mu: Param, nu: Param,
                       param: Param, inv_bc1: torch.Tensor,
                       inv_bc2: torch.Tensor) -> None:
        """:meth:`update` and the parameter add of :func:`run_octave`,
        written into ``mu``, ``nu`` and ``param`` with the eager loop's
        operations in its order. The bias corrections come as device
        tensors of their float32 reciprocals: on CUDA a tensor divided by
        a Python float is computed as the product with the scalar's
        float32 reciprocal, which these give bit for bit."""
        b1, b2 = self.b1, self.b2

        def leaf(g, m, v, p):
            torch.add((1 - b1) * g, b1 * m, out=m)
            torch.add((1 - b2) * g ** 2, b2 * v, out=v)
            u = -self.lr * ((m * inv_bc1) / (torch.sqrt(v * inv_bc2)
                                             + self.eps))
            torch.add(p, u, out=p)

        _leafwise(leaf, grad, mu, nu, param)


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
    losses_out = (torch.stack(losses) if losses else
                  torch.zeros((0,), dtype=torch.float32,
                              device=_device(param)))
    return param, losses_out, state


def _clone(x: Param) -> Param:
    return _leafwise(torch.clone, x)


def _device(param: Param) -> torch.device:
    return (next(iter(param.values())) if isinstance(param, dict)
            else param).device


class _OctaveGraph:
    """One key's CUDA graph of an Adam iteration and the static buffers it
    reads and writes: the param, Adam's moments, the octave's ``moved``
    entries of ``data`` (copied in once per octave), the view sets of every
    iteration, the bias corrections' reciprocals indexed by iteration, the
    per-iteration losses, and the iteration counter, which the graph
    increments itself. Everything is allocated before capture, outside the
    graph's memory pool. Every other entry of ``data`` is the object the
    graph was captured with, which each octave must hand in again.
    ``launches``: the hand kernels' launches of one replay, by counter."""

    def __init__(self, param: Param, data: Dict, views: Sequence,
                 iters: int, moved: Sequence[str]):
        self.iters = iters
        self.param = _leafwise(torch.empty_like, param)
        self.mu = _leafwise(torch.empty_like, param)
        self.nu = _leafwise(torch.empty_like, param)
        self.data = dict(data)
        self.moved = [k for k in moved if data.get(k) is not None]
        for k in self.moved:
            self.data[k] = torch.empty_like(data[k])
        dev = _device(param)
        # the grid is the image (2D): the loss takes no views
        self.positions = len(views[0])
        self.views = (None if views[0][0] is None else torch.empty(
            (iters, self.positions) + tuple(views[0][0].shape),
            dtype=views[0][0].dtype, device=dev))
        self.losses = torch.zeros((iters,), dtype=torch.float32, device=dev)
        self.it = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.inv_bc1 = torch.ones((iters,), dtype=torch.float32, device=dev)
        self.inv_bc2 = torch.ones_like(self.inv_bc1)
        # Adam's step count at iteration i is i + offset + 1
        self.offset = None
        self.graph = None
        self.launches = []

    def load(self, param: Param, data: Dict, views: Sequence,
             state: AdamState, start_iter: int, optimizer: Adam) -> None:
        """Copy one octave's inputs into the static buffers (``state``
        None: a fresh Adam); the host waits for nothing unless a resumed
        octave's step count calls for other bias corrections than the
        tables hold. Raises where an entry of ``data`` that is not moved
        is another object than the graph's."""
        stale = [k for k in data.keys() | self.data.keys()
                 if k not in self.moved
                 and data.get(k) is not self.data.get(k)]
        if stale:
            raise ValueError(f"the octave's {sorted(stale)} are not the "
                             f"objects its CUDA graph was captured with")
        _leafwise(torch.Tensor.copy_, self.param, param)
        if state is None:
            _leafwise(torch.Tensor.zero_, self.mu)
            _leafwise(torch.Tensor.zero_, self.nu)
        else:
            _leafwise(torch.Tensor.copy_, self.mu, state.mu)
            _leafwise(torch.Tensor.copy_, self.nu, state.nu)
        for k in self.moved:
            self.data[k].copy_(data[k])
        if self.views is not None:
            torch.stack([v for row in views for v in row],
                        out=self.views.view((-1,) + self.views.shape[2:]))
        offset = (0 if state is None else state.count) - start_iter
        if offset != self.offset:
            inv1, inv2 = [], []
            for i in range(self.iters):
                # (a resumed octave's iterations before start_iter: unused)
                bc1, bc2 = optimizer._corrections(max(i + offset + 1, 1))
                inv1.append(np.float32(1) / np.float32(bc1))
                inv2.append(np.float32(1) / np.float32(bc2))
            self.inv_bc1.copy_(torch.from_numpy(np.array(inv1, np.float32)))
            self.inv_bc2.copy_(torch.from_numpy(np.array(inv2, np.float32)))
            self.offset = offset
        self.it.fill_(start_iter)

    def step(self, loss_fn: Callable, optimizer: Adam) -> None:
        """One Adam iteration on the static buffers (what is captured)."""
        views = ([None] * self.positions if self.views is None
                 else self.views.index_select(0, self.it)[0])
        loss, grad = value_and_grad(loss_fn, self.param, views, self.data)
        with span("nfs.adam"):
            optimizer._step_in_place(
                grad, self.mu, self.nu, self.param,
                self.inv_bc1.index_select(0, self.it),
                self.inv_bc2.index_select(0, self.it))
        self.losses.index_copy_(0, self.it,
                                loss.detach().to(torch.float32).reshape(1))
        self.it.add_(1)


class _OctaveGraphs:
    """:func:`run_octave` on a GPU as CUDA graphs, one per key: the first
    octave run with a key captures one Adam iteration, and every
    iteration of it and of each later octave with the key replays that
    graph. The key must name whatever makes two octaves' iterations
    differ other than the static buffers' contents (``styler/grid.py``
    ``_octave_key``). A replay needs no host work besides the graph's
    launch; callbacks and checkpoints run between replays, at the eager
    loop's chunk ends. What leaves an octave (the param, the losses, Adam's
    state, what the callbacks receive) is a copy of the static buffers,
    which the next octave with the key overwrites.

    The graphs share one memory pool: their intermediates are dead between
    replays and two octaves never run at once. A capture that fails
    raises. The hand kernels' ``LAUNCHES`` count what the card launches:
    a capture's launches are taken back out, and each octave adds its
    replays' once it ends. Captures and replays are counted in
    ``captures`` and ``replays``; under the profiler they are the spans
    ``nfs.capture`` and ``nfs.replay`` (each replay inside ``nfs.iter``).
    """

    def __init__(self):
        self._graphs: Dict[Hashable, _OctaveGraph] = {}
        self._pool = None
        self.captures = 0
        self.replays = 0

    def _capture(self, g: _OctaveGraph, loss_fn, optimizer) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        counters = _LAUNCH_COUNTERS
        before = [dict(c) for c in counters]
        with span("nfs.capture"):
            # cuBLAS keeps a workspace per handle (the host thread's and
            # autograd's) and stream, and a capture allocates new ones for
            # its stream inside the graph's pool. Dropping the cached ones
            # before and after keeps the capture, and the eager work after
            # it, from holding both sets at once: the eager stream's come
            # back at its next product, and the graph's stay its own, free
            # in a pool that only this styler's captures draw from, which
            # never run at the same time as it.
            clear = getattr(torch._C, "_cuda_clearCublasWorkspaces",
                            lambda: None)
            clear()
            try:
                # torch's shared capture stream, the same for every capture
                with torch.cuda.graph(graph, pool=self._pool):
                    g.step(loss_fn, optimizer)
            finally:
                clear()
                # a captured launch runs at each replay, not at the capture
                g.launches = [{k: c[k] - b[k] for k in c}
                              for c, b in zip(counters, before)]
                for c, b in zip(counters, before):
                    c.update(b)
        g.graph = graph
        self.captures += 1

    def run(self, key: Hashable, param: Param, loss_fn: Callable, data,
            views: Sequence, iters: int, optimizer: Adam,
            moved: Sequence[str] = (), log_every: int = 10,
            callback: Callable = None, init_opt_state: AdamState = None,
            start_iter: int = 0, state_callback: Callable = None
            ) -> Tuple[Param, torch.Tensor, AdamState]:
        """:func:`run_octave`'s arguments and results, under ``key``
        (capturing it where it has no graph yet). ``moved``: the entries
        of ``data`` whose tensors may differ from octave to octave; the
        others must be the objects of the key's first octave."""
        if len(views) != iters:
            raise ValueError(f"{len(views)} view draws for {iters} "
                             f"iterations")
        count = 0 if init_opt_state is None else init_opt_state.count
        g = self._graphs.get(key)
        fresh = g is None
        if fresh:
            g = _OctaveGraph(param, data, views, iters, moved)
        g.load(param, data, views, init_opt_state, start_iter, optimizer)
        if fresh:
            self._capture(g, loss_fn, optimizer)
            self._graphs[key] = g
        observed = callback is not None or state_callback is not None
        chunk = log_every if observed else iters
        replayed = 0
        try:
            for i in range(start_iter, iters):
                with span("nfs.iter"), span("nfs.replay"):
                    g.graph.replay()
                replayed += 1
                done = i + 1
                if observed and (done % chunk == 0 or done == iters):
                    if state_callback is not None:
                        with span("nfs.checkpoint"):
                            state_callback(done, _clone(g.param), AdamState(
                                count + done - start_iter, _clone(g.mu),
                                _clone(g.nu)))
                    if callback is not None:
                        lo = max((done - 1) // chunk * chunk, start_iter)
                        with span("nfs.readback"):
                            # a copy: the eager loop's stacked losses
                            mean = float(g.losses[lo:done].clone().mean())
                        callback(done, mean)
        finally:
            self.replays += replayed
            for c, n in zip(_LAUNCH_COUNTERS, g.launches):
                for k, m in n.items():
                    c[k] += m * replayed
        return (_clone(g.param), g.losses[start_iter:].clone(),
                AdamState(count + iters - start_iter, _clone(g.mu),
                          _clone(g.nu)))


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
