"""The share of the program's sweep calls that reused the kernel's inputs
built by an earlier call: 100 x hits / (hits + builds) over the run, from
the counters of the wrapper that the runner's sweep adapter names
(`sweep.wrapper.input_hits` / `.input_builds`). None where the program
has no such counters or made no call."""


def read(ctx):
    adapter = getattr(getattr(ctx.runner, "sweep", None), "sweep_fn", None)
    wrapper = getattr(adapter, "wrapper", None)
    hits = getattr(wrapper, "input_hits", None)
    builds = getattr(wrapper, "input_builds", None)
    if hits is None or builds is None or hits + builds == 0:
        return None
    return 100.0 * hits / (hits + builds)
