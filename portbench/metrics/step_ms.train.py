"""Device milliseconds of the train step (CUDA events around each call of
the step), summed over the window's steps."""


def read(ctx):
    ms = ctx.get("step_ms")
    return sum(ms) if ms else None
