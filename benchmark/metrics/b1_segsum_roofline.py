"""B1, the sorted segment sum of the hash table's gradient
(``csrc/segment_sum.cu``, both launches of its ``TransposedLoader``
instantiation of ``csrc/segment_tiles.cuh``; B3's ``RowLoader`` and B4's
``FactorLoader`` do not match): its byte bound a step
(``roofline.b1_bytes_per_step``) times the traced steps, over its device
time in the traced window."""

KERNEL = "TransposedLoader"


def read(ctx):
    steps = ctx.counters.get("steps")
    if ctx.trace is None or not steps:
        return None
    busy = ctx.trace.kernel_seconds(KERNEL)
    if busy <= 0:
        return None
    bound = steps * ctx.roofline.b1_bytes_per_step(ctx.cfg) / ctx.roofline.HBM_BYTES_PER_S
    return 100.0 * bound / busy
