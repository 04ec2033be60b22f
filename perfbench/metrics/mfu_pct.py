"""The whole unit's share of the card's float32 peak: the algorithm's
operations at the cell's shapes (`counts`), over the untraced window's
time (a sweep call's outcomes on the host included)."""

from perfbench.counts import PEAK_F32_OPS_PER_S


def read(ctx):
    win = ctx.window
    if not win.attempted:
        return None
    return 100.0 * win.ops / win.seconds / PEAK_F32_OPS_PER_S
