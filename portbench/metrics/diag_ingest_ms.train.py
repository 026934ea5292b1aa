"""Host milliseconds of ingesting telemetry into the diagnosis's stage
windows (the root's own delta, and any aggregators' payloads), summed over
the window's steps."""


def read(ctx):
    return ctx["spans"].host_ms("diag_ingest", ctx["t0"], ctx["t1"])
