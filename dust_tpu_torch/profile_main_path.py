"""Where the time of one MPC step of the main path goes, on the card.

    python -m dust_tpu_torch.profile_main_path [--fused-solve] [--out DIR]

Builds the pendulum `dust` stack of `PENDULUM_DEMO_CONFIG` on the kernel
path (rollout-cost kernel + FusedPendulumMPF; with --fused-solve the
whole-solve kernel, FusedPendulumSVMPC, + FusedPendulumMPF), warms it up
for 5 steps, then runs 20 MPC steps under `torch.profiler` with one labelled
range per phase of the step (SVMPC optimize, SVMPC forward, simulator,
MPF optimize), composed as `PendulumSimulation.step_fn` composes them.
Reports, per step: the wall time of free-running steps; each phase's
host-clock time with the device drained after it; and from the profiled
pass the device's busy time (its idle share is taken against the
free-running wall time), the number of device operations and each
phase's span on the device. Writes the per-kernel table and the
summary to DIR/profile_main_path.txt (profile_main_path_fused_solve.txt
with --fused-solve; by default DIR is the gitignored output directory).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path


STEPS = 20
PHASES = ("svmpc.optimize", "svmpc.forward", "simulator.step",
          "mpf.optimize")


def _device_us(evt, self_only):
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .experiments import PENDULUM_DEMO_CONFIG, build_pendulum_stack
    from .inference import FusedPendulumMPF
    from .models import PendulumModel

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="chiprun_out")
    parser.add_argument("--fused-solve", action="store_true",
                        help="the whole-solve kernel path (K3 + K2)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA device")
    dev = torch.device("cuda")

    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    cfg["exp_params"]["fused_rollout"] = True
    cfg["exp_params"]["fused_solve"] = args.fused_solve
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = build_pendulum_stack(cfg, gen, case="dust", device=dev)
    mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    svmpc, ctrl = stack.svmpc, stack.controller
    sim = PendulumModel(g=10.0)
    true = {"length": torch.tensor(1.0, device=dev),
            "mass": torch.tensor(1.0, device=dev)}

    obs = stack.init_state.reshape(1, -1)
    dstate = ctrl.init_state(stack.init_policies)
    svstate = svmpc.init_state(stack.init_policies, stack.policies_prior)
    mstate = mpf.init_state(stack.mpf_init, obs[0], ctrl.dim_a)

    def phases(obs, dstate, svstate, mstate):
        """The step as (name, thunk) pairs; each thunk returns the carry
        (obs, dstate, svstate, mstate) after its phase."""
        box = {}

        def optimize():
            box["sv"], box["d"], box["costs"] = svmpc.optimize(
                svstate, dstate, obs, mstate.prior, gen)
            return obs, box["d"], box["sv"], mstate

        def forward():
            box["sv"], a_seq, _ = svmpc.forward(box["sv"], box["costs"],
                                                generator=gen)
            box["action"] = a_seq[0]
            return obs, box["d"], box["sv"], mstate

        def simulate():
            box["obs"] = sim.step(obs, box["action"][None], true)
            return box["obs"], box["d"], box["sv"], mstate

        def filter_():
            ms, _, _ = mpf.optimize(mstate, box["action"], box["obs"][0],
                                    bw=stack.mpf_bw, n_steps=stack.mpf_steps)
            return box["obs"], box["d"], box["sv"], ms

        return zip(PHASES, (optimize, forward, simulate, filter_))

    def step(obs, dstate, svstate, mstate):
        carry = (obs, dstate, svstate, mstate)
        for name, fn in phases(*carry):
            with record_function(name):
                carry = fn()
        return carry

    for _ in range(5):
        obs, dstate, svstate, mstate = step(obs, dstate, svstate, mstate)
    torch.cuda.synchronize()

    # free-running steps, one drain at the end: the loop's own pace
    t0 = time.perf_counter()
    for _ in range(STEPS):
        obs, dstate, svstate, mstate = step(obs, dstate, svstate, mstate)
    torch.cuda.synchronize()
    free_s = time.perf_counter() - t0

    # host-clock time per phase, with the device drained after each phase
    phase_s = dict.fromkeys(PHASES, 0.0)
    t_step = time.perf_counter()
    for _ in range(STEPS):
        for name, fn in phases(obs, dstate, svstate, mstate):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            phase_s[name] += time.perf_counter() - t0
            obs, dstate, svstate, mstate = out
    step_s = time.perf_counter() - t_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            obs, dstate, svstate, mstate = step(obs, dstate, svstate, mstate)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    averages = prof.key_averages()
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    kernels_us = sum(_device_us(e, True) for e in kernels)
    summary = {
        "steps": STEPS,
        "path": "K3 + K2" if args.fused_solve else "K1 + K2",
        "card": torch.cuda.get_device_name(0),
        "wall_ms_per_step": 1e3 * free_s / STEPS,
        "device_idle_share": 1.0 - kernels_us / 1e6 / free_s,
        "synced_ms_per_step": 1e3 * step_s / STEPS,
        "phase_ms_per_step": {k: 1e3 * v / STEPS
                              for k, v in phase_s.items()},
        "profiled_wall_ms_per_step": 1e3 * wall_s / STEPS,
        "device_busy_ms_per_step": kernels_us / 1e3 / STEPS,
        "profiled_device_idle_share": 1.0 - kernels_us / 1e6 / wall_s,
        "device_ops_per_step": sum(e.count for e in kernels) / STEPS,
        "device_span_ms_per_step": {
            e.key: _device_us(e, False) / 1e3 / STEPS
            for e in averages if e.key in PHASES
        },
    }
    table = averages.table(sort_by="self_cuda_time_total", row_limit=30)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    name = "profile_main_path" + ("_fused_solve" if args.fused_solve
                                  else "")
    (out / f"{name}.txt").write_text(
        table + "\n" + json.dumps(summary, indent=1) + "\n")
    print(table)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
