"""Host milliseconds an evaluation call spends in the ground-truth scans
(``Evaluator._get_gt_data``, E1 on the card and the host's arithmetic
around it): the port's span ``evaluator.gt_scan`` over the traced
window's calls."""


def read(ctx):
    s, calls = ctx.counters.get("span.evaluator.gt_scan.s"), ctx.counters.get("calls")
    if s is None or not calls:
        return None
    return 1e3 * s / calls
