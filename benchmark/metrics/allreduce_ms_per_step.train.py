"""Device milliseconds a data-parallel training step spends in NCCL's
kernels on rank 0's card: every kernel whose name holds ``nccl`` in the
traced window, over its steps.  In the step every collective is an
all-reduce: each gradient leaf's mean, the metrics, and at a grid update
the mean density and the summed evidence.  A collective's kernel runs from
its launch until the other ranks have joined, so the time counts the wait
for the slowest rank as well as the transfer."""


def read(ctx):
    steps = ctx.counters.get("steps")
    if ctx.trace is None or not steps:
        return None
    busy = sum(s for k, s in ctx.trace.kernel_s.items() if "nccl" in k.lower())
    if busy <= 0:
        return None
    return 1e3 * busy / steps
