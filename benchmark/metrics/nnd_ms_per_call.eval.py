"""Host milliseconds an evaluation call spends in the nearest-neighbour
distances (its three ``nn_metrics`` calls, on the host): the port's span
``evaluator.nnd`` over the traced window's calls."""


def read(ctx):
    s, calls = ctx.counters.get("span.evaluator.nnd.s"), ctx.counters.get("calls")
    if s is None or not calls:
        return None
    return 1e3 * s / calls
