"""Scenario sweeps: robustness studies in one launch per group (counterpart
of `demo/sweep_example.py`). N independent DuSt episodes with their own
true dynamics run in groups of 8, each group one launch of the sweep
kernel (K5 for the pendulum, K10 for the particle task) in its
device-RNG mode; on the CPU the kernels' plain versions compute the same
counter-based noise.

    python -m dust_tpu_torch.demo.sweep_example --task pendulum --scenarios 16 --steps 100
    python -m dust_tpu_torch.demo.sweep_example --task particle --scenarios 16 --steps 40

Pendulum: per-scenario true (length, mass) across the robustness range;
per-scenario lowest and tail swing-up costs. Particle: per-scenario true
base mass; success, crash and cost per scenario.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..experiments import (
    PARTICLE_DEMO_CONFIG,
    PARTICLE_TUNED_CONFIG,
    PENDULUM_DEMO_CONFIG,
    PENDULUM_TUNED_CONFIG,
    build_particle_stack,
    build_pendulum_stack,
)
from ..simulation import (
    megakernel_particle_sweep_fn,
    megakernel_pendulum_sweep_fn,
)
from ..utils.helper import to_np
from . import add_device_argument

# scenarios per launch
GROUP = 8


def group_seed(seed, g, device):
    """The sweep seed of group g."""
    return torch.tensor([seed + 1, g * 1000], device=device)


def pendulum_grid(device):
    """The 8 true (length, mass) pairs of a group: lengths 0.7-1.25
    against masses 1.25-0.7."""
    return (torch.linspace(0.7, 1.25, GROUP, device=device),
            torch.linspace(1.25, 0.7, GROUP, device=device))


def particle_grid(device):
    """The 8 true base masses of a group, 1.5-3.0."""
    return torch.linspace(1.5, 3.0, GROUP, device=device)


def pendulum_rows(out, lens, mass, g, steps):
    """Rows (scenario, length, mass, lowest cost in the second half, mean
    cost of the last 5 steps) of group g's sweep output."""
    cost = to_np(out["cost"])                   # [steps, S]
    lens, mass = to_np(lens), to_np(mass)
    half = steps // 2
    return [(g * GROUP + s, float(lens[s]), float(mass[s]),
             cost[half:, s].min(), cost[-5:, s].mean())
            for s in range(GROUP)]


def particle_rows(out, masses, g):
    """Rows (scenario, mass, success, crashed, cumulative cost) of group
    g's sweep output at its last step."""
    done = to_np(out["done"][-1])
    crashed = to_np(out["crashed"][-1])
    cum = to_np(out["cum"][-1])
    masses = to_np(masses)
    return [(g * GROUP + s, float(masses[s]),
             bool(done[s] > 0.5 and crashed[s] < 0.5),
             bool(crashed[s] > 0.5), cum[s])
            for s in range(GROUP)]


def run_sweep(config, task="pendulum", scenarios=16, steps=100, seed=0,
              device="cuda"):
    """Sweep max(1, scenarios // 8) groups of 8 scenarios of `task` with
    `config`, one launch per group, and print the rows and totals.
    Returns {"rows", "n", and "solved" (pendulum) or "success" and
    "crashed" (particle)}."""
    device = resolve_device(device)
    groups = max(1, scenarios // GROUP)
    n = groups * GROUP
    exp = config["exp_params"]
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    if task == "pendulum":
        stack = build_pendulum_stack(config, gen, case="dust", device=device)
        sweep = megakernel_pendulum_sweep_fn(stack, exp, steps=steps,
                                             n_sc=GROUP)
        lens, mass = pendulum_grid(device)
        for g in range(groups):
            out = sweep(group_seed(seed, g, device), lens, mass)
            rows += pendulum_rows(out, lens, mass, g, steps)
        print(f"{'scenario':>8} {'length':>7} {'mass':>6} "
              f"{'min_cost(2nd half)':>18} {'tail_cost':>10}")
        for r in rows:
            print(f"{r[0]:>8} {r[1]:>7.3f} {r[2]:>6.3f} "
                  f"{r[3]:>18.4f} {r[4]:>10.4f}")
        solved = sum(1 for r in rows if r[3] < 1.0)
        print(f"\nswing-up achieved: {solved}/{n} scenarios")
        return {"rows": rows, "n": n, "solved": solved}
    if task != "particle":
        raise ValueError(f"unknown task {task!r}")
    stack = build_particle_stack(config, gen, device=device)
    sweep = megakernel_particle_sweep_fn(stack, exp, steps=steps,
                                         n_sc=GROUP)
    masses = particle_grid(device)
    for g in range(groups):
        out = sweep(group_seed(seed, g, device), masses)
        rows += particle_rows(out, masses, g)
    print(f"{'scenario':>8} {'mass':>6} {'success':>8} "
          f"{'crashed':>8} {'cum_cost':>12}")
    for r in rows:
        print(f"{r[0]:>8} {r[1]:>6.3f} {str(r[2]):>8} "
              f"{str(r[3]):>8} {r[4]:>12.1f}")
    ok = sum(1 for r in rows if r[2])
    cr = sum(1 for r in rows if r[3])
    print(f"\nsuccess {ok}/{n}, crashed {cr}/{n}")
    return {"rows": rows, "n": n, "success": ok, "crashed": cr}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="scenario sweeps through the sweep kernels")
    parser.add_argument("--task", choices=("pendulum", "particle"),
                        default="pendulum")
    parser.add_argument("--scenarios", type=int, default=16)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tuned", action="store_true",
                        help="use the tuned config (PENDULUM_TUNED_CONFIG "
                        "/ PARTICLE_TUNED_CONFIG)")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    if args.task == "pendulum":
        config = PENDULUM_TUNED_CONFIG if args.tuned else PENDULUM_DEMO_CONFIG
    else:
        config = PARTICLE_TUNED_CONFIG if args.tuned else PARTICLE_DEMO_CONFIG
    return run_sweep(config, task=args.task, scenarios=args.scenarios,
                     steps=args.steps, seed=args.seed, device=device)


if __name__ == "__main__":
    main()
