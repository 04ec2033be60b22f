"""The share of the cart-pole episode kernel's rollout chunk-steps (K14,
`csrc/cartpole.cuh:rollout_mcost`) that took its branch-free sin/cos and
division rather than the library's: 100 x fast / (fast + fallback) over
the run, from the counts of the wrapper that the runner's sweep adapter
names (`sweep.wrapper.rollout_guard.fast` / `.fallback`). None where the
program has no such counts (K5, K10, the CPU) or made no launch."""


def read(ctx):
    adapter = getattr(getattr(ctx.runner, "sweep", None), "sweep_fn", None)
    guard = getattr(getattr(adapter, "wrapper", None), "rollout_guard", None)
    fast = getattr(guard, "fast", None)
    fallback = getattr(guard, "fallback", None)
    if fast is None or fallback is None or fast + fallback == 0:
        return None
    return 100.0 * fast / (fast + fallback)
