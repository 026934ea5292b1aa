"""The expert FFN's share of its roofline in serving: the least time its
three grouped products need at each call's routed group sizes, over the
device time of the program's ``moe_gmm_ffn`` calls, in percent."""
import torch

from portbench.yardstick.work import bound_s, moe_ffn_work


def read(ctx):
    ms = ctx["device_ms"].get("moe_gmm")
    if not ms:
        return None
    calls = ctx["calls"]["moe_gmm"]
    active = torch.stack([(c[3] > 0).sum() for c in calls]).tolist()
    need = sum(bound_s(moe_ffn_work(r, d, f, a))
               for (r, d, f, _), a in zip(calls, active))
    return 100.0 * need / (sum(ms) * 1e-3)
