"""The part of a traced step that its replayed graph does not cover, read
from the traced steps of a window.

A replayed step launches its captured graph under the program's
``capture.replay`` host range (``oppositerenderer_tpu_torch/capture.py``);
the graph's device operations carry the correlation id of that launch.
The graph holds a step from the range's start to the end of the last
operation launched under it. The rest of the step is the work before and
after the graph, host and device: the operand writes, the film's add or
the gradient's unpack, the readback and the loop's own work, each of
which the card waits through on an untraced step too.

The launch counts as the graph's: under the profiler the host takes
microseconds an operation to launch the graph and the card starts
milliseconds into it, a cost of the profiler's that an untraced replay
does not pay. The first traced step is left out: the profiler's first
CUDA call, about 2 ms, falls in it.
"""
from __future__ import annotations

REPLAY = "capture.replay"


def outside_graph_ms(ctx) -> float | None:
    """The mean, over the traced steps after the first, of a step's length
    less the stretch from its first ``capture.replay`` range's start to
    the end of the last device operation launched under it, in
    milliseconds. None with fewer than two traced steps, or where one of
    them holds no such range or no operation launched under one (a
    program without the span, or a route that does not replay)."""
    if ctx.trace is None or len(ctx.steps) < 2:
        return None
    starts = [r["ts"] for r in ctx.trace.ranges(REPLAY)]
    ends = [e["ts"] + e["dur"]
            for e in ctx.trace.launched_under(lambda name: name == REPLAY)]
    total = 0.0
    for a, b in ctx.steps[1:]:
        mine = [t for t in starts if a <= t < b]
        done = [t for t in ends if a < t <= b]
        if not mine or not done:
            return None
        total += (b - a) - (max(done) - min(mine))
    return total / (len(ctx.steps) - 1) / 1e3
