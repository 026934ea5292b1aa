"""Host milliseconds the train loop waited for its next batch from the
prefetcher, summed over the window's steps."""


def read(ctx):
    return ctx["spans"].host_ms("data_wait", ctx["t0"], ctx["t1"])
