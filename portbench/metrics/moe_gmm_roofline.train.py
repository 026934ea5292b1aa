"""The expert FFN's share of its roofline: the least time its three
grouped products need at each call's routed group sizes, over the device
time of the program's ``moe_gmm_ffn`` calls, in percent."""
from portbench.yardstick.work import bound_s, moe_ffn_work


def read(ctx):
    ms = ctx.get("moe_gmm_ms")
    if not ms:
        return None
    need = sum(bound_s(moe_ffn_work(r, d, f, a))
               for r, d, f, a in ctx["moe_gmm"])
    return 100.0 * need / (sum(ms) * 1e-3)
