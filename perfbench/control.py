"""Readings for a cell's correctness limits: the program's gaps from the
plain reference, and the control's (the reference in bfloat16 put in the
program's place), over several seeds in one process.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3
        [--seconds 3] [--steps K] [--fault state_unchanged] [--out FILE]

For each seed: the cell's set-up and warm-up, a short window at the
cell's own load, then the check's numbers for the program and for the
control, and the widest gap of each logged field at every one of the
first K steps. With --fault, the program runs with its MPF step planted
to return its particles unchanged, and only its numbers are read. One
JSON line per seed on standard output;
with --out, the lines are also written to FILE. Benchmark runs never run
the control; its limits come from these readings (PERF.md).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def mpf_frozen(task):
    """The program's MPF step planted to return its particles unchanged:
    the task's sweep adapter built with `mpf_steps` = 0."""
    from dust_tpu_torch import simulation

    name = f"megakernel_{task}_sweep_fn"
    make = getattr(simulation, name)

    def frozen(stack, exp_params, **kw):
        return make(stack, dict(exp_params, mpf_steps=0), **kw)

    setattr(simulation, name, frozen)
    try:
        yield
    finally:
        setattr(simulation, name, make)


def fault_readings(cell, seed, seconds, device):
    """One seed's numbers with the program's MPF frozen."""
    import torch

    from perfbench.run import judge

    with mpf_frozen(cell.config["task"]):
        runner = cell.runner(cell, seed, torch.device(device))
    runner.plan_samples(seconds, runner.warm_up())
    win = runner.window(seconds)
    numbers = runner.check()
    return {"seed": seed, "attempted": win.attempted,
            "fault": "state_unchanged", "program": numbers,
            "correct": judge(cell, numbers)[0] and win.failed == 0}


def readings(cell, seed, seconds, device, steps=None):
    """One seed's readings: {"seed", "program", "control"}, the first
    steps' numbers as the widest gap over all episodes beside them
    ("program_widest", "control_widest"), and "per_step.<side>" ({field:
    [the widest gap at step t]})."""
    import time

    import torch

    from perfbench.common import gap

    if steps is not None:
        cell.traffic = dict(cell.traffic,
                            check=dict(cell.traffic["check"], steps=steps))
    runner = cell.runner(cell, seed, torch.device(device))
    unit_s = runner.warm_up()
    runner.plan_samples(seconds, unit_s)
    win = runner.window(seconds)
    t = time.perf_counter()
    out = {"seed": seed, "attempted": win.attempted,
           "program": runner.check()}
    out["check_s"] = time.perf_counter() - t
    out["program_widest"] = runner.widest
    out["control"] = runner.check(control=True)
    out["control_widest"] = runner.widest
    for side, control in (("program", False), ("control", True)):
        got, want, _ = runner.first_steps(control)
        out[f"per_step.{side}"] = {
            f: [gap(got[f][:, t], want[f][:, t])
                for t in range(want[f].shape[1])] for f in want}
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--fault", choices=("state_unchanged",),
                        default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import load_cell

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = load_cell(args.workload, ROOT)
        if args.fault:
            r = fault_readings(cell, seed, args.seconds, "cuda")
        else:
            r = readings(cell, seed, args.seconds, "cuda", args.steps)
        line = json.dumps(r)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
