"""The device's idle share in the traced units (steps or calls): 100 x (1 -
the union of its activity over the slice's span)."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct()
