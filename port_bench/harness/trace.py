"""A ``torch.profiler`` trace, read: the device's operations, the host's
ranges and the launches that tie one to the other.

The profiler's Chrome trace is written to a temporary file under
``TMPDIR``, read and deleted. Times are microseconds on the trace's own
clock, which the host's ranges and the device's operations share.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@contextlib.contextmanager
def profiled(device_type: str):
    """Yields a running ``torch.profiler.profile`` of the host and, on the
    card, the device; read it with :meth:`Trace.of` after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


class Trace:
    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        for e in xs:
            e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
        self.device = sorted((e for e in xs if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.host = [e for e in xs if e.get("cat") in HOST_CATS]
        runtime = [e for e in xs if e.get("cat") in RUNTIME_CATS]
        self._runtime_by_tid = defaultdict(list)
        for e in sorted(runtime, key=lambda e: e["ts"]):
            self._runtime_by_tid[e.get("tid")].append(e)
        self._runtime_ts = {tid: [e["ts"] for e in evs]
                            for tid, evs in self._runtime_by_tid.items()}
        self._device_by_corr = defaultdict(list)
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                self._device_by_corr[corr].append(e)
        self._device_starts = [e["ts"] for e in self.device]

    @classmethod
    def of(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    # --- host ranges ------------------------------------------------------
    def ranges(self, name: str) -> list[dict]:
        """The host ranges called ``name`` (``record_function``), in time
        order."""
        return sorted((e for e in self.host if e.get("name") == name),
                      key=lambda e: e["ts"])

    # --- the device's operations -------------------------------------------
    def device_between(self, t0: float, t1: float) -> list[dict]:
        """Device operations that start in [t0, t1)."""
        lo = bisect.bisect_left(self._device_starts, t0)
        hi = bisect.bisect_left(self._device_starts, t1)
        return self.device[lo:hi]

    def busy_us(self, t0: float, t1: float) -> float:
        """Microseconds of [t0, t1) in which some device operation ran:
        the length of the union of their intervals, clipped."""
        return sum(b - a for a, b in self.busy_intervals(t0, t1))

    def busy_intervals(self, t0: float, t1: float) -> list[tuple]:
        merged: list[list[float]] = []
        for e in self.device:
            a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [tuple(m) for m in merged]

    def idle_gaps(self, t0: float, t1: float) -> list[tuple]:
        """(start, end) of every stretch of [t0, t1) with no device
        operation running."""
        gaps, cur = [], t0
        for a, b in self.busy_intervals(t0, t1):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if t1 > cur:
            gaps.append((cur, t1))
        return gaps

    def host_doing(self, t: float) -> str:
        """The innermost host operation or range running at ``t`` ("idle
        host" where none is)."""
        best = None
        for e in self.host:
            if e["ts"] <= t < e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best["dur"]):
                best = e
        return best["name"] if best else "idle host"

    def launched_under(self, match) -> list[dict]:
        """The device operations launched from inside a host range whose
        name satisfies ``match``: each operation whose launch (a runtime
        call on the range's thread, inside the range) carries its
        correlation id. An operation counts once however many matching
        ranges nest around its launch."""
        seen, out = set(), []
        for r in self.host:
            if not match(r.get("name", "")):
                continue
            tid = r.get("tid")
            ts = self._runtime_ts.get(tid, [])
            lo = bisect.bisect_left(ts, r["ts"])
            hi = bisect.bisect_right(ts, r["ts"] + r["dur"])
            for call in self._runtime_by_tid[tid][lo:hi]:
                corr = call.get("args", {}).get("correlation")
                if corr is None or corr in seen:
                    continue
                seen.add(corr)
                out.extend(self._device_by_corr.get(corr, ()))
        return out


def device_ms(events) -> float:
    return sum(e["dur"] for e in events) / 1e3
