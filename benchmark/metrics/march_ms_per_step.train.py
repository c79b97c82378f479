"""Device milliseconds a training step spends in the march
(``render_rays``: the cube intersection, the fused march L1 and the
compaction to the sample budget): the port's tracer's ``march`` phase
stamps (``phase.march.ms``, on the card's clock, replayed with the
chunk's graphs) over the traced window's steps."""


def read(ctx):
    ms, steps = ctx.counters.get("phase.march.ms"), ctx.counters.get("steps")
    if ms is None or not steps:
        return None
    return ms / steps
