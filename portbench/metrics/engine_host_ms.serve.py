"""Host milliseconds a round spends in the engine outside the model's
prefill call (with the wait for the device to finish it) and decode
calls (cache set-up, batching, token reads), the mean over the window's
rounds."""


def read(ctx):
    ms = ctx.get("engine_host_ms")
    return sum(ms) / len(ms) if ms else None
