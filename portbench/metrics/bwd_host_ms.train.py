"""Host milliseconds of the train step's backward (the program's
``train.backward`` spans, each microbatch's), per ``train.step``, the mean
over the window's steps."""
from portbench.harness.program_spans import ms_per


def read(ctx):
    return ms_per(ctx, "train.backward", "train.step")
