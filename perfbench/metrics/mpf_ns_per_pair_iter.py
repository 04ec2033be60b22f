"""The cost of one kernel-pair evaluation of the MPF's Stein loop: the
episode kernel's `mpf_loop` phase (its clock, `phases`) in ns per episode
step over mpf_n_particles^2 x mpf_steps. Comparable across the tasks'
kernels (K10 one value a particle, K5 and K14 two, K15 three), it tells
the posterior's width from its particle count. None where the program has
no clock or no rows come back."""

from perfbench.phases import summary


def read(ctx):
    out = summary(ctx)
    if out is None or "mpf_loop" not in out["phases"]:
        return None
    exp = ctx.runner.exp
    n = exp["mpf_n_particles"] ** 2 * exp["mpf_steps"]
    return 1e3 * out["phases"]["mpf_loop"]["us_per_step"] / n
