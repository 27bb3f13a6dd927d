"""outside_graph_ms.iter: milliseconds of a traced render step outside
the stretch from its ``capture.replay`` range's start to the end of the
last device operation launched under it (the frame's host path and
operand writes, the film's add, the readback), per step after the
first."""
from port_bench.harness import replay


def read(ctx):
    return replay.outside_graph_ms(ctx)
