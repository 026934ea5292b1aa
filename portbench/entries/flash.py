"""``ops.mha_flash(q, k, v, causal=)``: q's shape ``(B, S, H, D)``, the
keys' length and kv heads, and whether the call is causal."""


def record(a, k, out):
    return (*a[0].shape, a[1].shape[1], a[1].shape[2],
            k.get("causal", True))
