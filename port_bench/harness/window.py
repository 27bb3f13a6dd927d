"""What every loop shares: the window that drives a step for ``seconds``,
the spans around calls into the program's layers, and the program's
configuration of a cell.

A loop is ``loops/<loop>.py``, found by the name a traffic mix gives
(``cells.loop``); its ``run(cell, seed, seconds, trace, device, t0,
rehearsal)`` returns a :class:`Run`, whose ``finish`` frees the
program's state and runs the check once the peak memory has been read.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import torch

from .trace import Trace, profiled

STEP_RANGE = "port_bench.step"


@dataclasses.dataclass
class Run:
    setup_s: float
    step_s: list            # each step of the window, host clock
    window_s: float         # first step's start to the last one's end
    spans: dict             # harness spans around calls into layers
    trace: Trace | None = None      # the traced steps (--trace 1)
    eager: Trace | None = None      # a profiled eager body (--trace 1)
    finish: Callable[[], dict] | None = None  # -> numbers, work counts
    memory_peak_bytes: int = 0      # read as the window closed


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(spans: dict, name: str, device, fn):
    sync(device)
    t = time.perf_counter()
    out = fn()
    sync(device)
    spans[name] = time.perf_counter() - t
    return out


def peak(device) -> int:
    if device.type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def render_fields(cell, rehearsal: bool) -> tuple[str, dict]:
    """(scene name, RenderConfig fields by name) of the cell: the
    configuration's, the mix's method, and for a rehearsal the
    configuration's ``rehearsal`` overrides."""
    cfg = cell.config
    fields = dict(cfg["render_config"])
    fields.update(width=cfg["width"], height=cfg["height"],
                  render_method=cell.traffic["render_method"])
    scene = cfg["scene"]
    if rehearsal:
        over = dict(cfg.get("rehearsal", {}))
        scene = over.pop("scene", scene)
        fields.update(over)
    return scene, fields


def check_of(cell, rehearsal: bool) -> dict:
    """The cell's check parameters; for a rehearsal, with its
    ``rehearsal_check`` overrides."""
    out = dict(cell.check)
    if rehearsal:
        out.update(cell.rehearsal_check)
    return out


def port_config(fields: dict):
    """The program's ``RenderConfig`` of fields by name."""
    from oppositerenderer_tpu_torch import config as c
    kw = dict(fields)
    kw["render_method"] = c.RenderMethod[kw["render_method"]]
    if "photon_map_structure" in kw:
        kw["photon_map_structure"] = c.PhotonMapStructure[
            kw["photon_map_structure"]]
    return c.RenderConfig(**kw)


def window(step, seconds: float, device, trace_from: int | None,
           trace_steps: int, before=None, after=None):
    """Steps until ``seconds`` have passed since the first began, and the
    traced steps have run: (each step's seconds, the window's seconds,
    the traced steps' Trace).
    ``before(i)``/``after(i)`` run around step ``i`` outside its time;
    steps ``trace_from`` ... run under the profiler, each in a
    ``port_bench.step`` range."""
    times, prof = [], None
    i = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    t_end = t_start
    while True:
        if trace_from is not None and i == trace_from:
            t_prof = time.perf_counter()
            with profiled(device.type) as prof:
                for _ in range(trace_steps):
                    if before:
                        before(i)
                    t = time.perf_counter()
                    with torch.profiler.record_function(STEP_RANGE):
                        step(i)
                    t_end = time.perf_counter()
                    times.append(t_end - t)
                    if after:
                        after(i)
                    i += 1
            # the profiler's own start and stop do not shorten the window
            deadline += (time.perf_counter() - t_prof
                         - sum(times[-trace_steps:]))
        else:
            if before:
                before(i)
            t = time.perf_counter()
            step(i)
            t_end = time.perf_counter()
            times.append(t_end - t)
            if after:
                after(i)
            i += 1
        if t_end >= deadline and (trace_from is None or i > trace_from):
            break
    # the trace is read once the window has closed
    return times, t_end - t_start, None if prof is None else Trace.of(prof)
