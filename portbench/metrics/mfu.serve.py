"""The window's model FLOPs (2 x active parameters x prompt and generated
tokens served) over the window's length times the card's bf16 peak, in
percent."""
from portbench.yardstick.work import PEAK_FLOPS, serve_flops


def read(ctx):
    return 100.0 * serve_flops(ctx["active_params"], ctx["tokens"]) / (
        ctx["window_s"] * PEAK_FLOPS)
