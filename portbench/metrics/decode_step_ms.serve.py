"""Host milliseconds of a round's decode steps, from the prefill's end to
the last token read, summed over the window's rounds."""


def read(ctx):
    return sum(ctx["decode_ms"]) if ctx.get("decode_ms") else None
