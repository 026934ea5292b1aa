"""Host milliseconds of the train step's clip and AdamW update (the
program's ``train.optimizer`` spans) per ``train.step``, the mean over the
window's steps."""
from portbench.harness.program_spans import ms_per


def read(ctx):
    return ms_per(ctx, "train.optimizer", "train.step")
