"""vcm_splat_ms: device milliseconds of the operations launched under
the ``vcm_splat`` ranges (each light bounce's t=1 connections to the
camera, their shadow rays and their splats into the image), in a
profiled run of the eager body after the window."""
from port_bench.harness.trace import device_ms


def read(ctx):
    if ctx.eager is None:
        return None
    ops = ctx.eager.launched_under(lambda name: name == "vcm_splat")
    return device_ms(ops) if ops else None
