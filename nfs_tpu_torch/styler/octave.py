"""Octave Adam driver (counterpart of ``nfs_tpu/styler/octave.py``).

``run_octave`` optimizes one tensor, or a dict of tensors, under
``loss_fn(param, views, data) -> scalar``, where ``views`` is that
iteration's camera argument and ``data`` the octave's constants
(densities, VGG weights, Gram targets, view pool), eagerly on the param's
device; losses stay there until the caller reads them.
:class:`_OctaveGraphs` runs the same octave as CUDA graphs: the iteration
is captured once per key, in place on static buffers, and replayed, so
that it costs the host one launch (the grid styler's sequences,
``styler/grid.py`` ``_sweep``; the particle styler's keyframe sequences,
``styler/particle.py`` ``_graphed``). Both run one Adam formula
(``Adam._step``), one iteration (``_iteration``) and one chunk loop
(``_chunks``), and differ only in :func:`_bias_corrected`, which gives the
same bits on a GPU.

:class:`Adam` is ``optax.adam`` written out, over one tensor or a dict of
tensors: moments ``mu = (1-b1) g + b1 mu`` and ``nu = (1-b2) g^2 + b2
nu``, bias correction by ``1 - b^t``, ``eps`` added AFTER the square root
(``eps_root = 0``), step ``-lr * mu_hat / (sqrt(nu_hat) + eps)``.
``torch.optim.Adam`` is the same algorithm, but the functional form keeps
the state explicit per octave, as the JAX driver does.
"""

from __future__ import annotations

import gc
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


def _bias_corrected(x: torch.Tensor, bc) -> torch.Tensor:
    """``x`` under the bias correction ``bc``: divided by a Python float
    (the eager loop), multiplied by a device tensor of its float32
    reciprocal (a replay, which reads each iteration's from device memory).
    A GPU computes the division as that product: the same bits."""
    return x / bc if isinstance(bc, float) else x * bc


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
        """(step, new state): :meth:`_step` into new moments."""
        count = state.count + 1
        new = AdamState(count, _leafwise(torch.empty_like, state.mu),
                        _leafwise(torch.empty_like, state.nu))
        return (self._step(grad, state.mu, state.nu, new.mu, new.nu,
                           *self._corrections(count)), new)

    def _step(self, grad: Param, mu: Param, nu: Param, mu_out: Param,
              nu_out: Param, bc1, bc2) -> Param:
        """The formula: ``mu``, ``nu`` moved by ``grad`` into ``mu_out``,
        ``nu_out`` (new tensors, or ``mu``, ``nu`` in a graph); returns the
        step. ``bc1``, ``bc2``: the bias corrections."""
        b1, b2 = self.b1, self.b2

        def leaf(g, m, v, m_out, v_out):
            torch.add((1 - b1) * g, b1 * m, out=m_out)
            torch.add((1 - b2) * g ** 2, b2 * v, out=v_out)
            return -self.lr * (_bias_corrected(m_out, bc1) / (
                torch.sqrt(_bias_corrected(v_out, bc2)) + self.eps))

        return _leafwise(leaf, grad, mu, nu, mu_out, nu_out)

    def _corrections(self, count: int) -> Tuple[float, float]:
        """The bias corrections ``1 - b1^count`` and ``1 - b2^count``
        (optax computes decay**count in float32)."""
        one = np.float32(1)
        return (float(one - np.float32(self.b1) ** np.float32(count)),
                float(one - np.float32(self.b2) ** np.float32(count)))


def _iteration(loss_fn: Callable, param: Param, views, data,
               adam: Callable, in_place: bool = False):
    """Loss and gradient, then under ``nfs.adam`` the step ``adam(grad)``
    and the parameter add, into new tensors or (``in_place``) into
    ``param``. Returns (loss, param)."""
    loss, grad = value_and_grad(loss_fn, param, views, data)
    with span("nfs.adam"):
        param = _leafwise(lambda p, u: torch.add(
            p, u, out=p if in_place else None), param, adam(grad))
    return loss, param


def _chunks(iterate: Callable, iters: int, start_iter: int, log_every: int,
            callback, state_callback, snapshot, window) -> None:
    """``iterate(i)`` in ``nfs.iter`` for i in [start_iter, iters); after
    each chunk of ``log_every``, ``state_callback(done, *snapshot(done))``
    and ``callback(done, mean of window(lo, done))``, where given."""
    observed = callback is not None or state_callback is not None
    chunk = log_every if observed else iters
    for i in range(start_iter, iters):
        with span("nfs.iter"):
            iterate(i)
        done = i + 1
        if observed and (done % chunk == 0 or done == iters):
            if state_callback is not None:
                with span("nfs.checkpoint"):
                    state_callback(done, *snapshot(done))
            if callback is not None:
                lo = max((done - 1) // chunk * chunk, start_iter)
                with span("nfs.readback"):
                    mean = float(window(lo, done).mean())
                callback(done, mean)


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
    state = init_opt_state if init_opt_state is not None else opt.init(param)
    # the inputs are not held once the first iteration has replaced them
    param, init_opt_state = _leafwise(torch.Tensor.detach, param), None
    losses = []

    def adam(grad):     # the old moments go as soon as the new are made
        nonlocal state
        updates, state = opt.update(grad, state)
        return updates

    def iterate(i):
        nonlocal param
        loss, param = _iteration(loss_fn, param, views[i], data, adam)
        losses.append(loss.detach().to(torch.float32))

    _chunks(iterate, iters, start_iter, log_every, callback, state_callback,
            lambda done: (param, state),
            lambda lo, hi: torch.stack(
                losses[lo - start_iter:hi - start_iter]))
    return param, (torch.stack(losses) if losses else torch.zeros(
        (0,), dtype=torch.float32, device=_device(param))), state


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
    ``loss_shape``: the loss's shape (a keyframe batch's (B,) losses).
    ``launches``: the hand kernels' launches of one replay, by counter."""

    def __init__(self, param: Param, data: Dict, views: Sequence,
                 iters: int, moved: Sequence[str], loss_shape=()):
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
        self.losses = torch.zeros((iters,) + tuple(loss_shape),
                                  dtype=torch.float32, device=dev)
        self.it = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.inv_bc = torch.ones((2, iters), dtype=torch.float32, device=dev)
        # Adam's step count at iteration i is i + offset + 1
        self.offset = None
        self.start_iter = 0
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
            # (a resumed octave's iterations before start_iter: unused)
            bc = np.array([optimizer._corrections(max(i + offset + 1, 1))
                           for i in range(self.iters)], np.float32).T
            self.inv_bc.copy_(torch.from_numpy(np.float32(1) / bc))
            self.offset = offset
        self.start_iter = start_iter
        self.it.fill_(start_iter)

    def step(self, loss_fn: Callable, optimizer: Adam) -> None:
        """One Adam iteration on the static buffers (what is captured):
        :func:`_iteration` in place, its bias corrections read and its
        loss written at the counter."""
        def adam(grad):
            bc1, bc2 = self.inv_bc.index_select(1, self.it)
            return optimizer._step(grad, self.mu, self.nu, self.mu, self.nu,
                                   bc1, bc2)

        views = ([None] * self.positions if self.views is None
                 else self.views.index_select(0, self.it)[0])
        loss, _ = _iteration(loss_fn, self.param, views, self.data, adam,
                             in_place=True)
        self.losses.index_copy_(0, self.it,
                                loss.detach().to(torch.float32)[None])
        self.it.add_(1)


class _OctaveGraphs:
    """:func:`run_octave` on a GPU as CUDA graphs, one per key: the first
    octave run with a key captures one Adam iteration, and every
    iteration of it and of each later octave with the key replays that
    graph. The key must name whatever makes two octaves' iterations
    differ other than the static buffers' contents (``styler/grid.py``,
    ``styler/particle.py`` ``_octave_key``). A replay needs no host work
    besides the graph's launch. What leaves an octave (the param, the
    losses, Adam's state, what the callbacks receive) is a copy of the
    static buffers, which the next octave with the key overwrites.

    The graphs share one memory pool: their intermediates are dead between
    replays and two octaves never run at once. A capture that fails
    raises. The hand kernels' ``LAUNCHES`` count what the card launches:
    a capture's launches are taken back out, and each octave adds its
    replays' once it ends. Captures and replays are counted in
    ``captures`` and ``replays``; under the profiler they are the spans
    ``nfs.capture`` and ``nfs.replay`` (each replay inside ``nfs.iter``).

    A key is graphed only once its octave has run eagerly (:meth:`ran`):
    that run warms the iteration up (cuDNN's and cuBLAS's choices, the
    kernels' builds), so that the capture records what the eager loop
    runs. :meth:`ready` says whether it has; the caller adds its own
    conditions (a GPU, a sequence).
    """

    def __init__(self):
        self._graphs: Dict[Hashable, _OctaveGraph] = {}
        self._eager = set()
        self._pool = None
        self.captures = 0
        self.replays = 0

    def ran(self, key: Hashable) -> None:
        """Note that an octave with ``key`` ran eagerly."""
        self._eager.add(key)

    def ready(self, key: Hashable) -> bool:
        """Whether ``key`` has run eagerly, so that it captures or has a
        graph."""
        return key in self._eager

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
            # the collector stays off while capturing: a CUDA graph that it
            # frees then (another styler's, dropped in a cycle) would be
            # destroyed inside the capture, which invalidates it
            collecting = gc.isenabled()
            gc.disable()
            try:
                # torch's shared capture stream, the same for every capture
                with torch.cuda.graph(graph, pool=self._pool):
                    g.step(loss_fn, optimizer)
            finally:
                if collecting:
                    gc.enable()
                clear()
                # a captured launch runs at each replay, not at the capture
                g.launches = [{k: c[k] - b[k] for k in c}
                              for c, b in zip(counters, before)]
                for c, b in zip(counters, before):
                    c.update(b)
        g.graph = graph
        self.captures += 1

    def load(self, key: Hashable, param: Param, data, views: Sequence,
             iters: int, optimizer: Adam, moved: Sequence[str] = (),
             loss_shape=(), init_opt_state: AdamState = None,
             start_iter: int = 0) -> _OctaveGraph:
        """The key's graph with one octave's inputs copied into its static
        buffers (made here where the key has none yet; :meth:`replay`
        captures it). The copies are all that the replays read: a caller
        that drops its own inputs now holds no tensor twice while they
        run. ``moved``: the entries of ``data`` whose tensors may differ
        from octave to octave; the others must be the objects of the
        key's first octave. ``loss_shape``: the loss's shape."""
        if len(views) != iters:
            raise ValueError(f"{len(views)} view draws for {iters} "
                             f"iterations")
        g = self._graphs.get(key)
        if g is None:
            g = _OctaveGraph(param, data, views, iters, moved, loss_shape)
        g.load(param, data, views, init_opt_state, start_iter, optimizer)
        return g

    def replay(self, key: Hashable, g: _OctaveGraph, loss_fn: Callable,
               optimizer: Adam, log_every: int = 10,
               callback: Callable = None, state_callback: Callable = None
               ) -> Tuple[Param, torch.Tensor, AdamState]:
        """The octave :meth:`load` put into ``g``, every iteration a replay
        of the key's graph (captured first where the key has none yet);
        :func:`run_octave`'s results and callbacks."""
        if key not in self._graphs:
            self._capture(g, loss_fn, optimizer)
            self._graphs[key] = g
        before, start_iter = self.replays, g.start_iter

        def replay(_):
            with span("nfs.replay"):
                g.graph.replay()
            self.replays += 1

        def copies(done):
            return _clone(g.param), AdamState(
                g.offset + done, _clone(g.mu), _clone(g.nu))

        try:
            # the window is a copy, as the eager loop's stacked losses are
            _chunks(replay, g.iters, start_iter, log_every, callback,
                    state_callback, copies,
                    lambda lo, hi: g.losses[lo:hi].clone())
        finally:
            for c, n in zip(_LAUNCH_COUNTERS, g.launches):
                for k, m in n.items():
                    c[k] += m * (self.replays - before)
        param, state = copies(g.iters)
        return param, g.losses[start_iter:].clone(), state

    def drop(self, which: Callable[[Hashable], bool]) -> None:
        """Forget the graphs, and free the buffers, of the keys for which
        ``which`` holds."""
        for key in [k for k in self._graphs if which(k)]:
            del self._graphs[key]


def value_and_grad(loss_fn: Callable, param: Param, *args):
    """(loss, gradient of loss wrt every leaf of ``param``) with the
    leaves detached; a leaf the loss does not depend on gets zeros."""
    p = _leafwise(lambda t: t.detach().requires_grad_(True), param)
    leaves = list(p.values()) if isinstance(p, dict) else [p]
    loss = loss_fn(p, *args)
    grads = [None] * len(leaves)    # (the loss may not depend on param)
    if loss.requires_grad:
        # a vector of independent losses (a keyframe batch's): the
        # gradient of their sum is each one's own
        with span("nfs.backward"):
            grads = torch.autograd.grad(loss.sum() if loss.ndim else loss,
                                        leaves, allow_unused=True)
    grads = [torch.zeros_like(l) if g is None else g
             for l, g in zip(leaves, grads)]
    return loss, dict(zip(p, grads)) if isinstance(p, dict) else grads[0]
