"""device_idle.grad: the share of the traced gradient steps in which no
device operation ran (the union of their intervals), in percent."""


def read(ctx):
    return ctx.idle_percent()
