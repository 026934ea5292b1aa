"""Prefill attention's share of its roofline: the least time the attended
pairs need at each call's shape, over the device time of the program's
``mha_flash`` calls, in percent."""
from portbench.yardstick.work import bound_s, flash_work


def read(ctx):
    ms = ctx["device_ms"].get("flash")
    if not ms:
        return None
    need = sum(bound_s(flash_work(b, sq, sk, h, kv, d, causal))
               for b, sq, h, d, sk, kv, causal in ctx["calls"]["flash"])
    return 100.0 * need / (sum(ms) * 1e-3)
