"""Host milliseconds a call spends in ``Evaluator.render_batched`` (the
NeRF scans' chunked render, its copies in and out included): the port's
span ``evaluator.render`` over the traced window's calls."""


def read(ctx):
    s, calls = ctx.counters.get("span.evaluator.render.s"), ctx.counters.get("calls")
    if s is None or not calls:
        return None
    return 1e3 * s / calls
