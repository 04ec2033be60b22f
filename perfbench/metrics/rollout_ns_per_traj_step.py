"""The cost of one model step inside a rollout: the episode kernel's
`rollouts` phase (its clock, `phases`) in ns per episode step over the
trajectory steps of one episode step, params_samples x action_samples x
n_particles x horizon. Comparable across the tasks' kernels, it tells the
dynamics' cost from the horizon's. None where the program has no clock or
no rows come back."""

from perfbench.phases import summary


def read(ctx):
    out = summary(ctx)
    if out is None or "rollouts" not in out["phases"]:
        return None
    exp = ctx.runner.exp
    n = (exp["params_samples"] * exp["action_samples"] * exp["n_particles"]
         * exp["horizon"])
    return 1e3 * out["phases"]["rollouts"]["us_per_step"] / n
