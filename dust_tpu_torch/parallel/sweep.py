"""Scenario-sweep groups (counterpart of `dust_tpu/parallel/sweep.py:
MegakernelGroupSweep`, without a device mesh).

The sweep kernel (`ops/sweep_episode.py`) runs up to 16 scenarios x
n_chains episodes per group; the group axis is the data-parallel unit.
Here the G groups of one `run` fold into the kernel's grid: one launch
runs all of them. The JAX class's `mesh` argument (sharding groups over
several cards) is not taken: it waits for the multi-device layer
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations


class MegakernelGroupSweep:
    """Usage:
        sweep = MegakernelGroupSweep(megakernel_pendulum_sweep_fn(...))
        out = sweep.run(seeds [G, 2], true_lengths [G, n_sc],
                        true_masses [G, n_sc], host_eps=..., ...)

    `sweep_fn` is a sweep-kernel adapter
    (`simulation.megakernel_pendulum_sweep_fn`): its `groups` method
    takes the group axis in one launch. The mapped arguments follow the
    adapter's signature, each with a leading G axis (lengths and masses
    may also be shared [n_sc]). Returns the adapter's log dict with a
    leading group axis."""

    def __init__(self, sweep_fn):
        if not hasattr(sweep_fn, "groups"):
            raise TypeError(
                "MegakernelGroupSweep needs a sweep-kernel adapter "
                "(simulation.megakernel_pendulum_sweep_fn), whose groups "
                "method runs the group axis in one launch"
            )
        self.sweep_fn = sweep_fn

    def run(self, seeds, *mapped, **kw):
        return self.sweep_fn.groups(seeds, *mapped, **kw)
