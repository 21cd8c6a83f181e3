"""Percent of the traced solve in which no kernel, copy or set ran on the
card: 100 minus the union of the device's intervals over the window."""

def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
