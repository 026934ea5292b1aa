"""Host milliseconds of the diagnosis tick (the root's own delta, the sweep
of its stage windows, and what-if and forecast where the diagnosis runs
them), each ending in a device sync, summed over the window's steps."""


def read(ctx):
    return ctx["spans"].host_ms("diag_tick", ctx["t0"], ctx["t1"])
