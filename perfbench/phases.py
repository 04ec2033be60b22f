"""The sweep kernel's phase clock in a `--trace 1` run, read by
`step_rollout_us`, `step_svmpc_us` and `step_mpf_us`.

Once per run, after the traced slice, the traffic's `trace.warmup` calls
run again inside the program's `MegakernelGroupSweep.phase_clock()`: the
kernel's clocked build (`dust_tpu_torch/ops/phase_clock.py`), which stamps
the block barriers that close each phase of an episode step. Its
`summary` (each phase's us per step, the mean over the kernel's blocks)
is kept on the runner, so the three readers read one summary. The window
and the traced slice ran the unclocked build; the check compares the
window's kept call, so these calls move none of its numbers. None where
the program has no clock or no rows come back (the plain version on the
CPU).
"""

from __future__ import annotations

import sys

# the phases of a step (the kernel's CLOCK_PHASES) each reader sums; the
# rest of the loop (commit_simulator, log / cost_log and the loop's
# stores after its last step) is the remainder on the stderr line
GROUPS = {
    "rollout": ("noise", "draws", "rollouts"),
    "svmpc": ("silverman", "disco_weights", "disco_delta", "stein_forward"),
    "mpf": ("mpf_bandwidth", "mpf_loop"),
}


def _clocked(ctx):
    runner = ctx.runner
    clock = getattr(getattr(runner, "sweep", None), "phase_clock", None)
    if clock is None:
        return None
    with clock() as rows:
        for _ in range(runner.traffic["trace"]["warmup"]):
            runner.unit_call()
    if not rows:
        return None
    out = clock.summary(rows, runner.steps)
    phases = {k: v["us_per_step"] for k, v in out["phases"].items()}
    groups = {g: sum(phases[p] for p in ps) for g, ps in GROUPS.items()}
    loop = out["loop_us_per_step"]
    rest = ", ".join(f"{k} {v:.3f}" for k, v in phases.items()
                     if not any(k in ps for ps in GROUPS.values()))
    print(f"perfbench: phase clock, us per step (mean of {out['blocks']} "
          f"blocks): loop {loop:.3f}; " + ", ".join(
              f"{g} {v:.3f}" for g, v in groups.items())
          + f"; remainder {loop - sum(groups.values()):.3f} ({rest}); "
          f"unclocked kernel {_unclocked_us(ctx, runner.steps)} (traced "
          f"slice)", file=sys.stderr)
    return out


def _unclocked_us(ctx, steps):
    """The traced slice's episode kernels (unclocked), their mean time in
    us per step; "not measured" without them."""
    ks = [e - s for s, e, name, _ in (ctx.trace.device if ctx.trace else [])
          if "episode_kernel" in name]
    if not ks:
        return "not measured"
    return f"{1e6 * sum(ks) / len(ks) / steps:.3f}"


def summary(ctx):
    """The clock's summary of this run (made on the first call)."""
    runner = ctx.runner
    if not hasattr(runner, "phase_summary"):
        runner.phase_summary = _clocked(ctx)
    return runner.phase_summary


def group_us(ctx, group):
    """The phases of `GROUPS[group]`, summed, in us per episode step."""
    out = summary(ctx)
    if out is None:
        return None
    return sum(out["phases"][p]["us_per_step"] for p in GROUPS[group])
