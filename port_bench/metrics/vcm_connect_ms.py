"""vcm_connect_ms: device milliseconds of the operations launched under
the ``vcm_connect`` ranges (each camera bounce's next-event sample, its
vertex connections and their one batch of shadow rays), in a profiled
run of the eager body after the window."""
from port_bench.harness.trace import device_ms


def read(ctx):
    if ctx.eager is None:
        return None
    ops = ctx.eager.launched_under(lambda name: name == "vcm_connect")
    return device_ms(ops) if ops else None
