"""photon_pass_ms: device milliseconds of the operations launched under
the ``ppm_photon_pass`` range, in a profiled run of the eager body (the
plain version of the captured iteration) after the window."""
from port_bench.harness.trace import device_ms


def read(ctx):
    if ctx.eager is None:
        return None
    ops = ctx.eager.launched_under(lambda name: name == "ppm_photon_pass")
    return device_ms(ops) if ops else None
