"""Host launch calls a training step: the kernel and graph launches the
profiler saw the host make in the traced window, over the window's steps.
Under the chunk's CUDA graphs this is the graph launches and the few
kernels outside them."""


def read(ctx):
    steps = ctx.counters.get("steps")
    if ctx.trace is None or not steps:
        return None
    return ctx.trace.launches / steps
