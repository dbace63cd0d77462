"""The card's idle share of the traced window: 100 less the union of its
operations' intervals over the window."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
