"""Device milliseconds a training step spends in the forward pass
(``render_rays``: the encoder, the MLPs and the compositing): the port's
tracer's ``forward`` phase stamps (``phase.forward.ms``, on the card's
clock, replayed with the chunk's graphs) over the traced window's steps."""


def read(ctx):
    ms, steps = ctx.counters.get("phase.forward.ms"), ctx.counters.get("steps")
    if ms is None or not steps:
        return None
    return ms / steps
