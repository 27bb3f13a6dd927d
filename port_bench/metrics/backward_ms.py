"""backward_ms: device milliseconds of the operations that the autograd
engine launched (under its ``autograd::engine::evaluate_function``
ranges) in a profiled eager step, the captured step's plain version."""
from port_bench.harness.trace import device_ms

PREFIX = "autograd::engine::evaluate_function"


def read(ctx):
    if ctx.eager is None:
        return None
    ops = ctx.eager.launched_under(lambda name: name.startswith(PREFIX))
    return device_ms(ops) if ops else None
