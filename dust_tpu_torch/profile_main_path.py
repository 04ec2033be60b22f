"""Where the time of one MPC step of the pendulum's main path goes, on the
card.

    python -m dust_tpu_torch.profile_main_path [--fused-rollout]
        [--fused-solve] [--out DIR]

Builds the published pendulum `dust` stack (`build_pendulum_stack` of
`PENDULUM_DEMO_CONFIG`, with the config keys `fused_rollout` and
`fused_solve` as given) and its `PendulumSimulation`, runs `WARM_UP` steps
of the simulation's own `step_fn`, then `STEPS` more under
`utils.profiling.trace`. Reports, per step, each of the program's spans
found in the trace (the step's `svmpc.optimize`, `svmpc.forward`,
`simulator.step` and `mpf.optimize`; inside the MPF's `mpf.condition`,
`mpf.stein_steps` and `mpf.prior_refresh`): its host time and the device
time of the work launched inside it; and over the profiled window (the
steps' host-clock time, until the device has drained) the device's busy
time, its idle share and its operations. Writes the per-kernel table and
the summary to DIR/profile_main_path.txt (`_fused_rollout`,
`_fused_solve` added to the name with those keys; by default DIR is the
gitignored output directory) and the Chrome trace under DIR/traces/.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

WARM_UP = 5
STEPS = 20


def _device_us(evt, self_only):
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile(config, steps, device, out):
    """Profile `steps` steps of the `dust` stack that `config` builds on
    `device`, after `WARM_UP` steps; the Chrome trace goes under
    out/traces/. Returns (summary, the profiler's `key_averages()`)."""
    import torch

    from .experiments import build_pendulum_stack
    from .simulation import PendulumSimulation
    from .utils.profiling import block_until_ready, trace

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = build_pendulum_stack(config, gen, case="dust", device=dev)
    sim = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, warm_up=config["sim_params"]["warm_up"],
        mpf_bw=stack.mpf_bw, mpf_steps=stack.mpf_steps, device=dev)
    step = sim.step_fn(stack.dynamics_prior)
    obs = stack.init_state.reshape(1, -1)
    carry = (gen, obs, stack.controller.init_state(stack.init_policies),
             stack.svmpc.init_state(stack.init_policies,
                                    stack.policies_prior),
             stack.mpf.init_state(stack.mpf_init, obs[0],
                                  stack.controller.dim_a))
    true = {"length": torch.tensor(1.0, device=dev),
            "mass": torch.tensor(1.0, device=dev)}
    for t in range(WARM_UP):
        carry, log = step(carry, t, true)
    block_until_ready(log)
    with trace(Path(out) / "traces", device=dev) as tr:
        t0 = time.perf_counter()
        for t in range(WARM_UP, WARM_UP + steps):
            carry, log = step(carry, t, true)
        block_until_ready(log)
        window_s = time.perf_counter() - t0

    averages = tr.profiler.key_averages()
    cpu = torch.autograd.DeviceType.CPU
    spans = [e for e in averages
             if getattr(e, "is_user_annotation", False)
             and e.device_type == cpu]
    ops = [e for e in averages if e.device_type != cpu
           and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(_device_us(e, True) for e in ops)
    summary = {
        "steps": steps,
        "fused_rollout": bool(config["exp_params"].get("fused_rollout")),
        "fused_solve": bool(config["exp_params"].get("fused_solve")),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "window_ms_per_step": 1e3 * window_s / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": 1.0 - busy_us / 1e6 / window_s,
        "device_ops_per_step": sum(e.count for e in ops) / steps,
        "spans": {e.key: {"calls_per_step": e.count / steps,
                          "host_ms_per_step": e.cpu_time_total / 1e3 / steps,
                          "device_ms_per_step":
                              _device_us(e, False) / 1e3 / steps}
                  for e in spans},
        "trace": str(tr.path),
    }
    return summary, averages


def main(argv=None):
    import torch

    from .experiments import PENDULUM_DEMO_CONFIG

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out")
    parser.add_argument("--fused-rollout", action="store_true",
                        help="the config key fused_rollout (K1)")
    parser.add_argument("--fused-solve", action="store_true",
                        help="the config key fused_solve (K3)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")

    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    cfg["exp_params"]["fused_rollout"] = args.fused_rollout
    cfg["exp_params"]["fused_solve"] = args.fused_solve
    summary, averages = profile(cfg, STEPS, "cuda", args.out)
    table = averages.table(sort_by="self_cuda_time_total", row_limit=30)
    out = Path(args.out)
    name = "profile_main_path" + "".join(
        f"_{k}" for k in ("fused_rollout", "fused_solve") if summary[k])
    (out / f"{name}.txt").write_text(
        table + "\n" + json.dumps(summary, indent=1) + "\n")
    print(table)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
