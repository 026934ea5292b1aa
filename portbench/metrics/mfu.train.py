"""The window's model FLOPs (6 x active parameters x tokens trained) over
the window's length times the card's bf16 peak, in percent."""
from portbench.yardstick.work import PEAK_FLOPS, train_flops


def read(ctx):
    return 100.0 * train_flops(ctx["active_params"], ctx["tokens"]) / (
        ctx["window_s"] * PEAK_FLOPS)
