"""The device's idle time inside the program's `sweep.run` spans, as 100
x its share of the traced slice's span: the part of `idle_pct` that falls
inside the program's calls (`idle_pct` minus this is the caller's). None
without the spans or a device trace.

The profiler sets the card's events on the host's clock, and the two
clocks can sit apart by up to milliseconds in a run: a call's kernel then
seems to start before the host launched it, while the program still
builds its inputs. Where a call's longest kernel starts before the last
launch inside its `sweep.launch` span (the library's), that call's span is
set beside the card's events moved later by that lead."""

from perfbench.trace import Trace

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def card_leads(tr):
    """Per `sweep.launch` span in time order, the seconds by which the
    call's longest kernel leads the span's last launch (0 where it does
    not); [] where a span holds no launch or the kernels are too few."""
    calls = sorted(s for s, _, n in tr.host if n.startswith(LAUNCH_CALLS))
    launched = []
    for s, e in sorted((s, e) for s, e, n in tr.host
                       if n == "sweep.launch"):
        inside = [c for c in calls if s <= c <= e]
        if not inside:
            return []
        launched.append(inside[-1])
    kernels = [d for d in tr.device if d[3] == "kernel"]
    longest = sorted(sorted(kernels, key=lambda d: d[0] - d[1])[
        :len(launched)])
    if len(longest) < len(launched):
        return []
    return [max(0.0, c - k[0]) for k, c in zip(longest, launched)]


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device_in(*tr.window):
        return None
    w0, w1 = tr.window
    runs = sorted((max(s, w0), min(e, w1)) for s, e, n in tr.host
                  if n == "sweep.run" and min(e, w1) > max(s, w0))
    if not runs:
        return None
    leads = card_leads(tr)
    if len(leads) != len(runs):
        leads = [0.0] * len(runs)
    # the card's activity over the whole trace, so that a moved span
    # still meets it past the slice's edges
    busy = Trace(spans=[(min(d[0] for d in tr.device),
                         max(d[1] for d in tr.device))],
                 device=tr.device).busy_intervals()
    idle = 0.0
    for (s, e), lead in zip(runs, leads):
        a, b = s - lead, e - lead
        idle += (e - s) - sum(max(0.0, min(b, b1) - max(a, b0))
                              for b0, b1 in busy)
    return 100.0 * idle / tr.window_s
