"""The training step's share of the card's float32 peak: the MLP operations
of the samples the traced steps composited (their ``vr_samples``), forward
and backward (three times a forward pass), over the traced window's time
and the 67 TFLOP/s of float32 outside the tensor cores (the configurations
run float32 with TF32 off)."""


def read(ctx):
    vr = ctx.counters.get("vr_samples")
    if ctx.trace is None or not vr or ctx.trace.window_s <= 0:
        return None
    flops = 3.0 * vr * ctx.roofline.mlp_forward_flops(ctx.cfg["model"])
    return 100.0 * flops / ctx.trace.window_s / ctx.roofline.FP32_FLOPS
