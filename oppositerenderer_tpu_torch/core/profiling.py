"""Tracing: the nvToolsExt analog.

The counterpart of ``oppositerenderer_tpu/core/profiling.py``. The
reference wraps every render pass in Nsight nvtx ranges
(``RenderEngine/helpers/nsight.h:12-199``). In the port:

- ``span(name)``: a ``torch.profiler.record_function`` range, a named
  region of a profiler trace on the clock its device operations share
  (the nvtx::ScopedRange analog). With no profiler recording it costs one
  flag read and records nothing. A range is host-side only: it adds no
  node, event or operation to a CUDA graph. The frame path's spans
  (``renderer.*``, ``capture.replay``, ``diff.*``) are host ranges around
  a graph replay and the work beside it, none of which runs inside a
  capture.
- ``pass_scope(name)``: a ``span`` around a render pass. It yields a
  function the pass hands its outputs to; under :func:`nonfinite_check`
  that function records the first pass whose outputs hold a NaN or an
  infinity (``debug.check_iteration``), otherwise it returns them
  untouched.
- ``trace(logdir)``: a ``torch.profiler.profile`` of the host and, when a
  CUDA card is present, the card, written as a Chrome trace to
  ``logdir/trace.json`` (the Nsight capture analog); ``None`` runs the
  same code untraced.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
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
def span(name: str):
    """Named host range of a profiler trace: a ``record_function`` range
    while a ``torch.profiler`` records, nothing otherwise."""
    if torch.autograd._profiler_enabled():
        with torch.profiler.record_function(name):
            yield
    else:
        yield


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

    with span(name):
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

