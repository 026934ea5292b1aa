"""Host milliseconds of the train step's forward (the program's
``train.forward`` spans, each microbatch's), per ``train.step``, the mean
over the window's steps."""
from portbench.harness.program_spans import ms_per


def read(ctx):
    return ms_per(ctx, "train.forward", "train.step")
