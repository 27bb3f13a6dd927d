"""capture_s: seconds of the first call into the program's captured
route (its eager run and the CUDA graph capture), a harness span."""


def read(ctx):
    return ctx.spans.get("capture_s")
