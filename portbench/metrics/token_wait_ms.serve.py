"""Host milliseconds a decode step waits for its tokens (the program's
``serve.token_read`` spans around the step's device read): the card's
step time that the enqueue does not hide, the mean over the window's
decode steps."""
from portbench.harness.program_spans import ms_per


def read(ctx):
    return ms_per(ctx, "serve.token_read", "serve.decode")
