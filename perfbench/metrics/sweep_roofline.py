"""The sweep's kernels against their roofline: the least time of each
traced call's work on the card (the larger of its operations over the
float32 peak and its bytes over the memory peak, `counts`), summed, over
the device time of all kernels inside the calls' spans."""

from perfbench.counts import least_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    kernel_s = sum(ctx.trace.kernel_s_per_span())
    if kernel_s <= 0.0:
        return None
    least = sum(least_seconds(w.bytes, w.ops)[0] for w in ctx.unit_works)
    return 100.0 * least / kernel_s
