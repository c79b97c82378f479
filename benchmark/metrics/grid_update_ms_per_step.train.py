"""Device milliseconds a training step spends in the grid update (one an
update interval, its time spread over the interval's steps): the port's
tracer's ``grid_update`` phase stamps (``phase.grid_update.ms``, on the
card's clock, replayed with the chunk's graphs) over the traced window's
steps."""


def read(ctx):
    ms, steps = ctx.counters.get("phase.grid_update.ms"), ctx.counters.get("steps")
    if ms is None or not steps:
        return None
    return ms / steps
