"""Scenario sweeps (counterpart of `dust_tpu/parallel/sweep.py:
ScenarioSweep`, `MegakernelGroupSweep`, `ParticleScenarioSweep` and
`broadcast_scenarios`, without a device mesh).

The sweep kernels (`ops/sweep_episode.py`, `ops/particle_sweep_episode.py`)
run up to 16 scenarios x n_chains episodes per group; the group axis is
the data-parallel unit. Here the G groups of one `run` fold into the
kernel's grid: one launch runs all of them. `ScenarioSweep` and
`ParticleScenarioSweep` run the step-by-step episodes (pendulum and
particle) per scenario, one after another: the episodes are Python loops
over steps (the particle one reads its done flag on the host every step),
so the scenarios cannot be batched into one program as JAX's `vmap` does.
The JAX classes' `mesh` argument (sharding over several cards) waits for
the multi-device layer (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import torch

from ..device import resolve_device


class ScenarioSweep:
    """A `PendulumSimulation` episode over scenarios.

    Usage:
        sweep = ScenarioSweep(harness, dyn_dist)
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
    scenario reports NaN for itself only. `mesh` raises
    NotImplementedError: sharding scenarios over several cards waits for
    the multi-device layer."""

    def __init__(self, harness, static_dyn_dist=None, mesh=None,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "ScenarioSweep takes no device mesh yet (the multi-device "
                "layer is not ported)")
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
        for i in range(n):
            gen = torch.Generator(device=self.device).manual_seed(
                int(seeds[i]))
            true = {k: v[i] for k, v in true_params.items()}
            _, log = self.episode(gen, true, init_obs[i], dstate[i],
                                  svstate[i], mstate[i])
            logs.append(log)
        states, actions, costs = (torch.stack([log[j] for log in logs])
                                  for j in range(3))
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
        sweep = MegakernelGroupSweep(megakernel_pendulum_sweep_fn(...))
        out = sweep.run(seeds [G, 2], true_lengths [G, n_sc],
                        true_masses [G, n_sc], host_eps=..., ...)

    `sweep_fn` is a sweep-kernel adapter
    (`simulation.megakernel_pendulum_sweep_fn` or
    `megakernel_particle_sweep_fn`): its `groups` method takes the group
    axis in one launch. The mapped arguments follow the adapter's
    signature, each with a leading G axis (true parameters may also be
    shared [n_sc]). Returns the adapter's log dict with a leading group
    axis."""

    def __init__(self, sweep_fn):
        if not hasattr(sweep_fn, "groups"):
            raise TypeError(
                "MegakernelGroupSweep needs a sweep-kernel adapter "
                "(simulation.megakernel_pendulum_sweep_fn or "
                "megakernel_particle_sweep_fn), whose groups method runs "
                "the group axis in one launch"
            )
        self.sweep_fn = sweep_fn

    def run(self, seeds, *mapped, **kw):
        return self.sweep_fn.groups(seeds, *mapped, **kw)


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
    cum_cost [N] (inf on a crash), success_rate and crash_rate.
    `mesh` raises NotImplementedError: sharding scenarios over several
    cards waits for the multi-device layer."""

    def __init__(self, episode_fn, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "ParticleScenarioSweep takes no device mesh yet (the "
                "multi-device layer is not ported)")
        self.episode_fn = episode_fn

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
        for i in range(n):
            gen = torch.Generator(device=dev).manual_seed(int(seeds[i]))
            state, done, crashed, cum, _ = self.episode_fn(
                gen, state0[i], dstate[i], svstate[i], mstate[i],
                sim_mass[i])
            finals.append(state)
            dones.append(bool(done))
            crashes.append(bool(crashed))
            cums.append(cum)
        done = torch.tensor(dones, device=dev)
        crashed = torch.tensor(crashes, device=dev)
        cum = torch.where(crashed, torch.full((n,), float("inf"), device=dev),
                          torch.stack(cums).to(torch.float32))
        success = done & ~crashed
        return {
            "final_state": torch.stack(finals),
            "success": success,
            "crashed": crashed,
            "cum_cost": cum,
            "success_rate": success.to(torch.float32).mean(),
            "crash_rate": crashed.to(torch.float32).mean(),
        }
