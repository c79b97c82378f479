"""Device milliseconds a training step spends in the backward pass
(``loss.backward()``, B1 among it): the port's tracer's ``backward``
phase stamps (``phase.backward.ms``, on the card's clock, replayed with
the chunk's graphs) over the traced window's steps."""


def read(ctx):
    ms, steps = ctx.counters.get("phase.backward.ms"), ctx.counters.get("steps")
    if ms is None or not steps:
        return None
    return ms / steps
