"""The least time a kernel's work could take on the card, from the work
the inputs need: the larger of its FP32 operations over the published
FP32 peak and its bytes over the published HBM rate.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit
(dense, outside the tensor cores): 67e12 FP32 operations a second, a
fused multiply-add counted as two, and 3.35e12 HBM bytes a second. The
card's power limit is recorded beside every share (``device`` in the
result line). The rays each call has alive are the plain reference's
expectation for the cell's estimator (``reference/<name>.py``'s
``iteration_tiles``):

* a Moller-Trumbore ray-triangle test is 46 FP32 operations (9 + 5 + 1 +
  3 + 6 + 9 + 6 + 6 + 1, comparisons not counted); B1 tests every
  triangle for each live ray;
* bytes: each input byte read once and each output written once: every
  lane's tmin, tmax and four outputs (24 bytes), each live lane's origin
  and direction (24), the triangle table's 48 bytes a triangle.
"""
from __future__ import annotations

PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
MT_FLOPS = 46


def least_seconds(flops: float, n_bytes: float) -> float:
    return max(flops / PEAK_FP32_PER_S, n_bytes / PEAK_BYTES_PER_S)


def b1_work(call: dict) -> tuple[float, float]:
    """(FP32 operations, bytes) of one B1 call."""
    flops = call["live"] * call["triangles"] * MT_FLOPS
    n_bytes = call["lanes"] * 24 + call["live"] * 24 + call["triangles"] * 48
    return float(flops), float(n_bytes)


WORK = {"b1_closest": b1_work}


def least_ms(calls: list[dict], kernel: str) -> float | None:
    """The least milliseconds of every call of ``kernel`` in ``calls``,
    summed: each call's own bound, as each is a launch of its own."""
    mine = [c for c in calls if c["kernel"] == kernel]
    if not mine:
        return None
    return sum(least_seconds(*WORK[kernel](c)) for c in mine) * 1e3
