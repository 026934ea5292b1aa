"""Host milliseconds of a decode step's enqueue (the program's
``serve.decode`` spans around each step's model call), the mean over the
window's decode steps.  Read it with ``token_wait_ms.serve``: while the
card paces decode, a shorter enqueue lengthens the wait by what it
saves."""
from portbench.harness.program_spans import ms_per


def read(ctx):
    return ms_per(ctx, "serve.decode", "serve.decode")
