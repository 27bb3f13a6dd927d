"""One run of one cell: set-up, the window, the reference, the result.

With ``--trace 0`` the result's metrics are the cell's end-to-end
metrics, taken on the host's clock; with ``--trace 1`` its per-layer
metrics, each read by its reader (``metrics/<name>.py``) from a
:class:`Context`, and the device's busy and window seconds. Either way
the check runs and ``correct`` means the same.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time

import torch

from . import card, cells, compare
from .window import STEP_RANGE
from .trace import Trace

BREAKDOWN_ENTRIES = 10


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: "cells.Cell"
    spans: dict               # seconds of the harness's spans
    trace: Trace | None       # the traced steps of the window
    steps: list               # their (start, end), trace microseconds
    eager: Trace | None       # a profiled eager body or step
    work: list | None         # the kernels' calls with the rays alive in each

    def step_device_events(self, first_only: bool = False) -> list:
        if self.trace is None:
            return []
        steps = self.steps[:1] if first_only else self.steps
        return [e for a, b in steps for e in self.trace.device_between(a, b)]

    def idle_percent(self) -> float | None:
        if not self.steps or not self.step_device_events():
            return None
        a, b = self.steps[0][0], self.steps[-1][1]
        return 100.0 * (1.0 - self.trace.busy_us(a, b) / (b - a))


def end_to_end(cell, run) -> dict:
    """The host clock's metrics of the window, by name."""
    n = len(run.step_s)
    per = {"setup_s": (run.setup_s, "s"),
           "iter_ms": (run.window_s / n * 1e3, "ms"),
           "grad_step_ms": (run.window_s / n * 1e3, "ms")}
    p95 = (statistics.quantiles(run.step_s, n=20)[18] if n >= 2
           else run.step_s[0])
    per["iter_ms_p95"] = (p95 * 1e3, "ms")
    out = {}
    for m in cell.end_to_end:
        value, unit = per[m["name"]]
        out[m["name"]] = {"value": value, "unit": unit}
    return out


def breakdown(trace: Trace, steps: list) -> dict:
    """The device operations that took most time over the traced steps,
    and the longest idle gaps, each named by what the host was doing."""
    a, b = steps[0][0], steps[-1][1]
    by_name: dict = {}
    for e in trace.device_between(a, b):
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    gaps = sorted(trace.idle_gaps(a, b), key=lambda g: g[0] - g[1])
    idle = [[trace.host_doing((g0 + g1) / 2), (g1 - g0) / 1e6]
            for g0, g1 in gaps[:BREAKDOWN_ENTRIES]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def run(name: str, seed: int, seconds: float, trace: bool, t0: float,
        device_name: str | None = None, bench_dir=cells.BENCH_DIR,
        benchmark: dict | None = None) -> dict:
    """Runs the cell and returns the result line's object. Raises
    ``card.NoCard`` without the cards the cell needs, unless
    ``device_name`` asks for a rehearsal on the CPU."""
    if benchmark is None:
        benchmark = cells.load_benchmark()
    cell = cells.resolve(name, bench_dir, benchmark)
    rehearsal = device_name == "cpu"
    if not rehearsal:
        card.require(cell.chips)
    device = torch.device("cpu" if rehearsal else "cuda:0")
    started = {"imports_s": time.perf_counter() - t0}
    if device.type == "cuda":
        from oppositerenderer_tpu_torch.accel import cuda_build
        t = time.perf_counter()
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
        started["cuda_init_s"] = time.perf_counter() - t
        t = time.perf_counter()
        cuda_build.library()        # nvcc once a checkout, then its cache
        started["kernel_library_s"] = time.perf_counter() - t
    loop = cells.loop(cell.traffic["loop"], bench_dir)
    r = loop(cell, seed, seconds, trace, device, t0, rehearsal=rehearsal)
    print("set-up spans: " + ", ".join(
        f"{k} {v:.3f}" for k, v in {**started, **r.spans,
                                    "setup_s": r.setup_s}.items()),
          file=sys.stderr)
    t_check = time.perf_counter()
    checked = r.finish()
    check_s = time.perf_counter() - t_check
    ok, table = compare.judge(checked["numbers"], cell.limits)

    dev = card.describe(device, cell.chips)
    dev["memory_peak_bytes"] = r.memory_peak_bytes
    result = {"correct": ok, "attempted": len(r.step_s),
              "failed": 0 if ok else sum(
                  1 for v in table.values() if not (
                      v["value"] is not None and v["limit"] is not None
                      and v["value"] <= v["limit"])),
              "metrics": {}, "device": dev}
    if trace:
        steps = ([(e["ts"], e["ts"] + e["dur"])
                  for e in r.trace.ranges(STEP_RANGE)] if r.trace else [])
        ctx = Context(cell=cell, spans=r.spans, trace=r.trace, steps=steps,
                      eager=r.eager, work=checked.get("work"))
        for m in cell.per_layer:
            value = cells.reader(m["name"], bench_dir)(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if steps and r.trace is not None:
            window = steps[-1][1] - steps[0][0]
            dev["busy_s"] = r.trace.busy_us(steps[0][0], steps[-1][1]) / 1e6
            dev["window_s"] = window / 1e6
            result["breakdown"] = breakdown(r.trace, steps)
    else:
        result["metrics"] = end_to_end(cell, r)
    result["seed"] = seed
    result["checked"] = checked["checked"]
    result["check_s"] = check_s
    if rehearsal:
        result["rehearsal"] = True
    result["check"] = table
    for k, v in table.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    return result
