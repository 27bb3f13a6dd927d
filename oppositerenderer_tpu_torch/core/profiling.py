"""Tracing and timing: the nvToolsExt / BenchmarkTimer analog.

The counterpart of ``oppositerenderer_tpu/core/profiling.py``. The
reference wraps every render pass in Nsight nvtx ranges
(``RenderEngine/helpers/nsight.h:12-199``) and times with a pausable wall
timer (``util/BenchmarkTimer.h:11-29``). In the port:

- ``pass_scope(name)``: a ``torch.profiler.record_function`` range around
  a render pass, so each pass is a named region of a profiler trace (the
  nvtx::ScopedRange analog). It yields a function the pass hands its
  outputs to; under :func:`nonfinite_check` that function records the
  first pass whose outputs hold a NaN or an infinity (``debug.
  check_iteration``), otherwise it returns them untouched.
- ``trace(logdir)``: a ``torch.profiler.profile`` of the host and, when a
  CUDA card is present, the card, written as a Chrome trace to
  ``logdir/trace.json`` (the Nsight capture analog); ``None`` runs the
  same code untraced.
- ``BenchmarkTimer``: the reference's pausable wall timer.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time
from pathlib import Path

import torch

TRACE_FILE = "trace.json"

_CHECK: contextvars.ContextVar["NonFiniteCheck | None"] = \
    contextvars.ContextVar("nonfinite_check", default=None)


@dataclasses.dataclass
class NonFiniteCheck:
    """The first pass, in the order the passes finish, whose outputs held
    a non-finite float, and what it was."""

    message: str | None = None

    def visit(self, name: str, outputs) -> None:
        if self.message is not None:
            return
        for field, t in _float_tensors(outputs):
            bad = int((~torch.isfinite(t.detach())).sum())
            if bad:
                self.message = (f"pass {name}: {bad} non-finite values of "
                                f"{t.numel()} in its output {field}")
                return


def _float_tensors(obj, path: str = "out"):
    """(path, tensor) for every floating tensor in ``obj``: a tensor, or
    tuples, lists, dicts and dataclasses of them."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            yield path, obj
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            yield from _float_tensors(v, f"{path}[{i}]")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _float_tensors(v, f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _float_tensors(getattr(obj, f.name),
                                      f"{path}.{f.name}")


@contextlib.contextmanager
def nonfinite_check():
    """Inside the block, every pass_scope checks its pass's outputs; yields
    the :class:`NonFiniteCheck` that holds the first failure."""
    check = NonFiniteCheck()
    token = _CHECK.set(check)
    try:
        yield check
    finally:
        _CHECK.reset(token)


@contextlib.contextmanager
def pass_scope(name: str):
    """Named region for a render pass (nvtx::ScopedRange analog,
    helpers/nsight.h). Yields ``outputs(x) -> x``, through which the pass
    returns what it computed."""
    def outputs(x):
        check = _CHECK.get()
        if check is not None:
            check.visit(name, x)
        return x

    with torch.profiler.record_function(name):
        yield outputs


@contextlib.contextmanager
def trace(logdir: str | Path | None):
    """Profile the block into ``logdir/trace.json`` (Chrome trace format,
    for Perfetto or chrome://tracing): host operations, the pass scopes
    and, when a CUDA card is present, its kernels. ``logdir=None`` runs the
    block untraced. Yields the profiler, or None."""
    if logdir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / TRACE_FILE))


class BenchmarkTimer:
    """Pausable wall-clock timer (util/BenchmarkTimer.h:11-29): accumulates
    elapsed time across start/pause cycles; ``seconds`` reads the running
    total without stopping."""

    def __init__(self, start: bool = False):
        self._accum = 0.0
        self._started_at: float | None = None
        if start:
            self.start()

    def start(self) -> None:
        if self._started_at is None:
            self._started_at = time.perf_counter()

    def pause(self) -> None:
        if self._started_at is not None:
            self._accum += time.perf_counter() - self._started_at
            self._started_at = None

    def reset(self) -> None:
        self._accum = 0.0
        self._started_at = None

    def restart(self) -> None:
        self.reset()
        self.start()

    @property
    def running(self) -> bool:
        return self._started_at is not None

    @property
    def seconds(self) -> float:
        live = (time.perf_counter() - self._started_at
                if self._started_at is not None else 0.0)
        return self._accum + live
