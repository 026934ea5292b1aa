"""Host milliseconds of a serving round in the engine itself: the
program's ``serve.round`` span less its ``serve.prefill``,
``serve.decode`` and ``serve.token_read`` children (cache set-up,
batching, the first token's argmax, the loop), the mean over the window's
rounds."""
from portbench.harness.program_spans import self_ms


def read(ctx):
    return self_ms(ctx, "serve.round")
