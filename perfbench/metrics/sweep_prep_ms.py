"""The host's time per traced call from the start of the program's
`sweep.run` span to the end of its `sweep.launch` span: the kernel's
inputs built from the call's arguments, until the launch is queued. The
mean over the calls, in ms; None without the spans or a device
trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device_in(*tr.window):
        return None
    launches = [(s, e) for s, e, n in tr.host if n == "sweep.launch"]
    prep = []
    for s, e, n in tr.host:
        if n == "sweep.run":
            ends = [le for ls, le in launches if s <= ls and le <= e]
            if ends:
                prep.append(max(ends) - s)
    return 1e3 * sum(prep) / len(prep) if prep else None
