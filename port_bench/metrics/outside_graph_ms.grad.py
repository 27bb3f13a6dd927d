"""outside_graph_ms.grad: milliseconds of a traced gradient step outside
the stretch from its ``capture.replay`` range's start to the end of the
last device operation launched under it (the leaf and operand writes,
the unpack, the loop's descent update), per step after the first."""
from port_bench.harness import replay


def read(ctx):
    return replay.outside_graph_ms(ctx)
