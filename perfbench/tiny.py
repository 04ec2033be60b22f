"""Cells cut to a size that a CPU test can hold, with the widths and
traffic of each cell shrunk alike (the tests' stand-in; the benchmark's
runs never use it)."""

from __future__ import annotations

import copy
import dataclasses

from perfbench.harness import ROOT, load_cell


def tiny_cell(workload, root=ROOT):
    """`workload`'s cell with horizon 6, 2 policy particles, 8 samples, 2
    parameter draws, an MPF of 8 particles x 3 steps, and 2 groups x 2
    scenarios x 2 chains of 12-step episodes a call."""
    cell = load_cell(workload, root)
    cfg = copy.deepcopy(cell.config)
    cfg["config"]["exp_params"].update(
        horizon=6, n_particles=2, action_samples=8, params_samples=2,
        mpf_n_particles=8, mpf_steps=3)
    tr = copy.deepcopy(cell.traffic)
    tr.update(groups=2, n_sc=2, n_chains=2, episode_steps=12,
              warm_up_calls=1, trace={"warmup": 1, "active": 2})
    tr["check"] = dict(tr["check"], steps=4)
    return dataclasses.replace(cell, config=cfg, traffic=tr)
