"""One CUDA graph around a body that reads and writes static buffers.

The JAX package compiles its render step, its sharded step and its
sharded gradient with ``jax.jit``. On the card the port captures each in
a CUDA graph instead: ``renderer.CapturedStep`` (one iteration),
``parallel.render.make_sharded_render_fn`` (the tile-sharded step, its
collectives included) and ``diff.make_sharded_loss_and_grad`` (forward,
backward and the gradient ``psum``). :class:`CapturedCall` is the
machinery the three share: the eager first run, the capture, the kernel
launches the capture recorded, its cost, and its release.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable

import torch


class CapturedCall:
    """``body()`` run eagerly on the first call, then captured in a CUDA
    graph on ``device`` and replayed on every later call.

    The body reads its operands from static buffers that the caller sets
    before each :meth:`run` (fills and device copies) and returns tensors
    (or tuples or dicts of them); the graph writes that same output,
    ``out``, on every replay, so a caller that keeps a result across calls
    copies it.

    The first run executes the body eagerly and returns its result: that
    builds the kernels, the scene's caches, an NCCL communicator and the
    autograd engine's lazy state, which a capture may not create. Then the
    body is captured. A capture that fails raises; nothing retries it
    eagerly. A kernel wrapper counts its Python calls, so the counts it
    gained during the capture, where nothing launched, are taken back and
    kept as ``capture_launches``; each replay launches them once
    (:meth:`launches`). ``capture_seconds`` is the capture's host time and
    ``pool_bytes`` the memory it reserved (the graph's pool).

    A subclass may override :meth:`body` instead of passing ``fn``; it
    must not store a bound method of itself, whose reference cycle would
    leave the graph and its pool to the cycle collector."""

    def __init__(self, fn: Callable[[], Any] | None, device: torch.device):
        self._fn = fn
        self.device = device
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: Any = None
        self.capture_launches: dict[str, int] = {}
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def body(self):
        """One run of the captured work on the static buffers."""
        return self._fn()

    def run(self):
        """The body's result: eagerly, then captured, on the first call; a
        replay (the static ``out``) after."""
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            return self.out
        out = self.body()
        self._capture()
        return out

    def _capture(self) -> None:
        from .accel import kernel_wrappers
        wrappers = kernel_wrappers()
        before = [w.launches for w in wrappers]
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # no cycle collection inside the capture: a graph it frees is
        # destroyed there, which a capturing stream refuses (the capture
        # is invalidated)
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                self.out = self.body()
        finally:   # the wrappers were called, but launched nothing
            if gc_was_on:
                gc.enable()
            self.capture_launches = {w.__name__: w.launches - b
                                     for w, b in zip(wrappers, before)}
            for w, b in zip(wrappers, before):
                w.launches = b
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph

    def launches(self) -> dict[str, int]:
        """Kernel launches of the replays so far, per wrapper name."""
        return {k: c * self.replays for k, c in self.capture_launches.items()}

    def release(self) -> None:
        """Drop the graph and its outputs and return its memory pool."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = None
        torch.cuda.empty_cache()


def set_operand(buf: torch.Tensor, value) -> None:
    """Write ``value`` (a Python number, or a tensor or array of ``buf``'s
    size on any device) into the static buffer ``buf``, converted to its
    dtype: a fill or a copy, made outside any capture."""
    if isinstance(value, (int, float)):
        buf.fill_(value)
    else:
        buf.copy_(torch.as_tensor(value).reshape(buf.shape))
