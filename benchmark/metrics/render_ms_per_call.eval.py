"""Host milliseconds a call spends in ``Evaluator.render_batched`` (the
NeRF scans' chunked render, its copies in and out included): a harness
span around it in each traced call."""


def read(ctx):
    spans = ctx.spans.get("render_s")
    calls = ctx.counters.get("calls")
    if not spans or not calls:
        return None
    return 1e3 * sum(spans) / calls
