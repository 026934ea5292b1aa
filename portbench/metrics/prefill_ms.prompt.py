"""Host milliseconds from a round's send to the moment the device has
finished its prefill (cache set-up, prefill; the logits that give the
first token), summed over the window's rounds."""


def read(ctx):
    return sum(ctx["prefill_ms"]) if ctx.get("prefill_ms") else None
