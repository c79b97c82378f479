"""The share of the traced evaluation window in which no operation ran on
the card (the union of its kernels, copies and fills, against the
window's length on the profiler's clock)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
