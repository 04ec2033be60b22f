"""Scenario sweeps (counterpart of `dust_tpu/parallel/sweep.py:
ScenarioSweep`, `MegakernelGroupSweep`, `ParticleScenarioSweep` and
`broadcast_scenarios`).

The sweep kernels (`ops/sweep_episode.py`, `ops/particle_sweep_episode.py`)
run up to 16 scenarios x n_chains episodes per group; the group axis is
the data-parallel unit. Here the G groups of one `run` fold into the
kernel's grid: one launch runs all of them. `ScenarioSweep` and
`ParticleScenarioSweep` run the step-by-step episodes (pendulum and
particle) per scenario, one after another: the episodes are Python loops
over steps (the particle one reads its done flag on the host every step),
so the scenarios cannot be batched into one program as JAX's `vmap` does.

With a `mesh` (`parallel.make_mesh`) the scenario (or group) axis splits
over the ranks of its `axis`: each rank runs its contiguous block, the
per-scenario outputs are gathered, and every rank returns the whole
result. The reductions (`mean_cost_healthy`, `success_rate`,
`crash_rate`) are taken on the gathered tensors, so a NaN scenario stays
isolated across ranks and the result is bit-equal to the run without a
mesh. The leading axis must divide by the axis size.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..utils.profiling import span
from .mesh import all_gather_rows, block, check_axis


def _rows(n, mesh, axis):
    """The scenario indices this rank runs: all of them without a mesh."""
    if mesh is None:
        return range(n)
    return range(n)[block(n, mesh, axis)]


def _gather_fields(out, mesh, axis):
    """A dict of float32 tensors with a leading axis of this rank's rows,
    gathered over `axis` in one collective."""
    if mesh is None:
        return out
    b = next(iter(out.values())).shape[0]
    packed = all_gather_rows(
        torch.cat([v.reshape(b, -1) for v in out.values()], dim=1), mesh,
        axis)
    gathered, start = {}, 0
    for k, v in out.items():
        width = v[0].numel()
        gathered[k] = packed[:, start:start + width].reshape(-1, *v.shape[1:])
        start += width
    return gathered


class ScenarioSweep:
    """A `PendulumSimulation` episode over scenarios.

    Usage:
        sweep = ScenarioSweep(harness, dyn_dist, mesh)
        out = sweep.run(seeds [N], true_params {k: [N]}, init_obs [N, 1, S],
                        dstate, svstate, mstate)

    Scenario i runs `harness.episode_fn(static_dyn_dist)` with a
    `torch.Generator` on `device` seeded with seeds[i] (the counterpart of
    JAX's per-lane keys), the true parameters {k: v[i]}, init_obs[i] and
    the states dstate[i], svstate[i], mstate[i] (sequences of N, as
    `broadcast_scenarios` makes them). Returns costs [N, steps], states
    [N, steps, S], actions [N, steps, A], avg_cum_cost [N], healthy [N]
    (a finite cumulative cost) and mean_cost_healthy (the mean of
    avg_cum_cost over the healthy scenarios, NaN if none is): a diverged
    scenario reports NaN for itself only. With a `mesh`, each rank runs
    its block of scenarios along `axis` and every rank returns the whole
    result."""

    def __init__(self, harness, static_dyn_dist=None, mesh=None,
                 axis="scenario", device="cuda"):
        check_axis(mesh, axis)
        self.mesh = mesh
        self.axis = axis
        self.device = resolve_device(device)
        if harness.device.type != self.device.type:
            raise ValueError(
                f"the harness runs on {harness.device}, the sweep on "
                f"{self.device}")
        self.harness = harness
        self.episode = harness.episode_fn(static_dyn_dist)

    def run(self, seeds, true_params, init_obs, dstate, svstate, mstate):
        n = len(seeds)
        for name, v in (("init_obs", init_obs), ("dstate", dstate),
                        ("svstate", svstate), ("mstate", mstate),
                        *((f"true_params[{k!r}]", v)
                          for k, v in true_params.items())):
            if len(v) != n:
                raise ValueError(f"{name} must hold {n} scenarios, got "
                                 f"{len(v)}")
        logs = []
        for i in _rows(n, self.mesh, self.axis):
            gen = torch.Generator(device=self.device).manual_seed(
                int(seeds[i]))
            true = {k: v[i] for k, v in true_params.items()}
            _, log = self.episode(gen, true, init_obs[i], dstate[i],
                                  svstate[i], mstate[i])
            logs.append(log)
        out = _gather_fields(
            {name: torch.stack([log[j] for log in logs])
             for j, name in enumerate(("states", "actions", "costs"))},
            self.mesh, self.axis)
        states, actions, costs = out["states"], out["actions"], out["costs"]
        cum = costs.sum(dim=1)
        avg_cum = cum / costs.shape[1]
        healthy = torch.isfinite(cum)
        return {
            "costs": costs,              # [N, steps]
            "states": states,            # [N, steps, S]
            "actions": actions,          # [N, steps, A]
            "avg_cum_cost": avg_cum,     # [N]
            "healthy": healthy,          # [N]
            "mean_cost_healthy": torch.nanmean(torch.where(
                healthy, avg_cum, torch.full_like(avg_cum, float("nan")))),
        }


class MegakernelGroupSweep:
    """Usage:
        sweep = MegakernelGroupSweep(megakernel_pendulum_sweep_fn(...), mesh)
        out = sweep.run(seeds [G, 2], true_lengths [G, n_sc],
                        true_masses [G, n_sc], host_eps=..., ...)

    `sweep_fn` is a sweep-kernel adapter
    (`simulation.megakernel_pendulum_sweep_fn` or
    `megakernel_particle_sweep_fn`): its `groups` method takes the group
    axis in one launch. The mapped arguments follow the adapter's
    signature, each with a leading G axis (true parameters may also be
    shared [n_sc]). Returns the adapter's log dict with a leading group
    axis.

    With a `mesh`, each rank launches its G / p groups along `axis` in
    one launch (`local`) and every rank returns all G groups. The
    kernels key each episode's randomness on its (seed, step, scenario),
    not on its place in the launch, so a rank's groups are bit-equal to
    the same groups of one launch. Arguments with a leading G axis are
    split; a 1-D [n_sc] true-parameter vector, shared by every group,
    goes whole to every rank."""

    def __init__(self, sweep_fn, mesh=None, axis="scenario"):
        if not hasattr(sweep_fn, "groups"):
            raise TypeError(
                "MegakernelGroupSweep needs a sweep-kernel adapter "
                "(simulation.megakernel_pendulum_sweep_fn or "
                "megakernel_particle_sweep_fn), whose groups method runs "
                "the group axis in one launch"
            )
        check_axis(mesh, axis)
        self.sweep_fn = sweep_fn
        self.mesh = mesh
        self.axis = axis

    @property
    def phase_clock(self):
        """The sweep kernel's `ops.phase_clock.PhaseClock` (the adapter's):
        calls inside `with sweep.phase_clock() as rows:` launch its
        clocked build."""
        return self.sweep_fn.phase_clock

    def local(self, seeds, *mapped, **kw):
        """The rank's groups in one launch (the adapter's `groups`)."""
        return self.sweep_fn.groups(seeds, *mapped, **kw)

    def run(self, seeds, *mapped, **kw):
        """One call, in a `sweep.run` span; inside it the adapter's
        `sweep.inputs`, `sweep.launch` and `sweep.outputs` spans and, with
        a mesh, `sweep.gather`.

        A repeat call with the same mapped tensors (or their rank's rows)
        and new seeds reuses the kernel inputs the adapter's wrapper built
        for the first (`ops/sweep_inputs.py`); an in-place write to one
        builds afresh. A tensor written outside torch (NumPy into a
        `torch.from_numpy` tensor's memory, DLPack, `data_ptr`, `.data`)
        keeps its version: pass it as a new object after such a write."""
        with span("sweep.run"):
            if self.mesh is None:
                return self.local(seeds, *mapped, **kw)
            rows = block(len(seeds), self.mesh, self.axis)

            def split(v):
                if v is None or torch.as_tensor(v).ndim < 2:
                    return v
                return v[rows]

            out = self.local(seeds[rows], *map(split, mapped),
                             **{k: split(v) for k, v in kw.items()})
            with span("sweep.gather"):
                return _gather_fields(out, self.mesh, self.axis)


def broadcast_scenarios(tree, n):
    """An initial state for each of n scenarios: n references to `tree`.
    The port's episodes replace their states and never write into them,
    so the scenarios may share one."""
    return [tree] * n


class ParticleScenarioSweep:
    """Usage:
        sweep = ParticleScenarioSweep(particle_episode_fn(...))
        out = sweep.run(seeds [N], state0 [N, 4], dstate, svstate, mstate,
                        sim_mass [N])

    `episode_fn` is `simulation.particle_episode_fn`'s episode. Scenario i
    runs with a `torch.Generator` seeded with seeds[i] on state0's device
    (the counterpart of JAX's per-lane keys), its initial state state0[i],
    the per-scenario states dstate[i], svstate[i], mstate[i] (sequences of
    N, as `broadcast_scenarios` makes them) and true base mass
    sim_mass[i]. Returns final_state [N, 4], success, crashed [N] (bool),
    cum_cost [N] (inf on a crash), success_rate and crash_rate. With a
    `mesh`, each rank runs its block of scenarios along `axis` and every
    rank returns the whole result."""

    def __init__(self, episode_fn, mesh=None, axis="scenario"):
        check_axis(mesh, axis)
        self.episode_fn = episode_fn
        self.mesh = mesh
        self.axis = axis

    def run(self, seeds, state0, dstate, svstate, mstate, sim_mass):
        n = len(seeds)
        for name, v in (("state0", state0), ("dstate", dstate),
                        ("svstate", svstate), ("mstate", mstate),
                        ("sim_mass", sim_mass)):
            if len(v) != n:
                raise ValueError(f"{name} must hold {n} scenarios, got "
                                 f"{len(v)}")
        dev = torch.as_tensor(state0).device
        finals, dones, crashes, cums = [], [], [], []
        for i in _rows(n, self.mesh, self.axis):
            gen = torch.Generator(device=dev).manual_seed(int(seeds[i]))
            state, done, crashed, cum, _ = self.episode_fn(
                gen, state0[i], dstate[i], svstate[i], mstate[i],
                sim_mass[i])
            finals.append(state)
            dones.append(bool(done))
            crashes.append(bool(crashed))
            cums.append(cum)
        out = _gather_fields({
            "final_state": torch.stack(finals).to(torch.float32),
            "done": torch.tensor(dones, dtype=torch.float32, device=dev),
            "crashed": torch.tensor(crashes, dtype=torch.float32,
                                    device=dev),
            "cum": torch.stack(cums).to(torch.float32),
        }, self.mesh, self.axis)
        done, crashed = out["done"] > 0.5, out["crashed"] > 0.5
        cum = torch.where(crashed, torch.full((n,), float("inf"), device=dev),
                          out["cum"])
        success = done & ~crashed
        return {
            "final_state": out["final_state"],
            "success": success,
            "crashed": crashed,
            "cum_cost": cum,
            "success_rate": success.to(torch.float32).mean(),
            "crash_rate": crashed.to(torch.float32).mean(),
        }
