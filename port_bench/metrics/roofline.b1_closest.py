"""roofline.b1_closest: the least time of the first traced step's B1
(closest hit, csrc/intersect.cu) calls, from the work of the rays the
plain reference expects alive in each call, over their device time in
the trace, in percent."""
from port_bench.harness import roofline

KERNEL = "closest_hit_tris_kernel("


def read(ctx):
    if not ctx.work:
        return None
    least = roofline.least_ms(ctx.work, "b1_closest")
    ms = sum(e["dur"] for e in ctx.step_device_events(first_only=True)
             if KERNEL in e["name"]) / 1e3
    return 100.0 * least / ms if least and ms else None
