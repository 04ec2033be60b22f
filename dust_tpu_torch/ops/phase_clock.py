"""The clocked builds of the kernels (K2, K3, K4/K5, K6, K7, K8,
K9/K10): a measurement aid that splits a kernel's time by phase.

Inside `PhaseClock`'s context a wrapper launches its kernel's clocked
build (`csrc/phase_clock.cuh`): thread 0 of every block stamps clock64 at
the block barriers that close the phases of a step and writes one int64
row per block, each phase's cycles summed over the steps, then the whole
loop's cycles and its %globaltimer nanoseconds. The results are the
unclocked build's; the time is not (the marks add barriers).
`PhaseClock.summary` turns the rows into time per step.
"""

from __future__ import annotations

import contextlib

import torch


class PhaseClock:
    """The clock of one kernel, whose phases are `phases` in order.
    Calling it gives the context; `rows(blocks, device)` gives a launch's
    clock rows inside it (None outside)."""

    def __init__(self, phases):
        self.phases = tuple(phases)
        self._open = []

    @contextlib.contextmanager
    def __call__(self):
        """Launches inside this context take the clocked build; yields a
        list that receives each launch's [blocks, len(phases) + 2] int64
        clock rows."""
        rows = []
        self._open.append(rows)
        try:
            yield rows
        finally:
            self._open.remove(rows)

    def rows(self, blocks, device):
        """The rows a launch of `blocks` blocks writes, handed to the
        innermost open context; None when no context is open."""
        if not self._open:
            return None
        clock = torch.zeros((blocks, len(self.phases) + 2),
                            dtype=torch.int64, device=device)
        self._open[-1].append(clock)
        return clock

    def summary(self, rows, steps, per="step"):
        """The time of each phase from the clock rows of launches (the
        context's list, each [blocks, len(phases) + 2]), each block's
        cycles at its own cycles-to-%globaltimer rate, the mean over the
        blocks, over `steps` per launch: {"blocks", "loop_us_per_<per>"
        (the loop's %globaltimer time), "ns_per_cycle" (the blocks' mean),
        "phases": {phase: {"us_per_<per>", "share" (of all phases'
        cycles)}}}."""
        clk = torch.cat(rows).double().cpu()
        n = len(self.phases)
        ns_per_cycle = clk[:, n + 1] / clk[:, n]    # per block
        us = (clk[:, :n] * ns_per_cycle[:, None]).mean(0) / (1e3 * steps)
        total = clk[:, :n].sum()
        return {
            "blocks": int(clk.shape[0]),
            f"loop_us_per_{per}": float(clk[:, n + 1].mean()) / (1e3 * steps),
            "ns_per_cycle": float(ns_per_cycle.mean()),
            "phases": {k: {f"us_per_{per}": float(us[i]),
                           "share": float(clk[:, i].sum() / total)}
                       for i, k in enumerate(self.phases)},
        }
