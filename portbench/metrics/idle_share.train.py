"""Share of the traced window in which no operation ran on the device, in
percent."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"])
