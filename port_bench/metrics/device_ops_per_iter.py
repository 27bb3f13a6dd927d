"""device_ops_per_iter: the device operations (kernels, copies and
fills) that ran in the traced steps of the window, per step."""


def read(ctx):
    events = ctx.step_device_events()
    return len(events) / len(ctx.steps) if events else None
