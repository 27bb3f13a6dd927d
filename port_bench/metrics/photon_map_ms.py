"""photon_map_ms: device milliseconds of the operations launched under
the ``ppm_grid_build`` and ``ppm_indirect_gather`` ranges (the grid build
and the B3 tile gather), in a profiled run of the eager body after the
window."""
from port_bench.harness.trace import device_ms

RANGES = ("ppm_grid_build", "ppm_indirect_gather")


def read(ctx):
    if ctx.eager is None:
        return None
    ops = ctx.eager.launched_under(lambda name: name in RANGES)
    return device_ms(ops) if ops else None
