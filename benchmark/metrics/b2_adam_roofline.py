"""B2, Adam over every leaf in one launch (``csrc/fused_adam.cu``,
``fused_adam_kernel``): its byte bound a step (``roofline.b2_bytes_per_step``)
times the traced steps, over its device time in the traced window."""

KERNEL = "fused_adam_kernel"


def read(ctx):
    steps = ctx.counters.get("steps")
    if ctx.trace is None or not steps:
        return None
    busy = ctx.trace.kernel_seconds(KERNEL)
    if busy <= 0:
        return None
    bound = steps * ctx.roofline.b2_bytes_per_step(ctx.cfg) / ctx.roofline.HBM_BYTES_PER_S
    return 100.0 * bound / busy
