"""The particle's sweep (K10, `particle_episode.cu`):
`MegakernelGroupSweep` over `megakernel_particle_sweep_fn`, a true base
mass per scenario, +`extra_load` from a quarter of the episode."""

from __future__ import annotations

import torch

from perfbench import counts
from perfbench.common import Sweep, Work, gap


def _pair(d, a, b):
    return torch.stack([d[a], d[b]], dim=-1)


class Runner(Sweep):
    OUTCOME = ("cost", "done")

    def adapter(self, cfg, arrays):
        from dust_tpu_torch.experiments import assemble_particle_stack
        from dust_tpu_torch.simulation import megakernel_particle_sweep_fn

        stack = assemble_particle_stack(cfg, arrays, device=self.device)
        return megakernel_particle_sweep_fn(
            stack, cfg["exp_params"], steps=self.steps, n_sc=self.n_sc,
            n_chains=self.C)

    def work(self, outcome):
        """The MPF skips the steps after an episode has ended."""
        done = outcome[1]                      # [G, (C,) steps, n_sc]
        ended = float(done.movedim(-2, -1)[..., :-1].sum())
        updates = self.B * self.steps - ended
        ops, nbytes = counts.particle_work(
            self.exp, self.cfg["env_params"], self.steps, updates, self.B)
        return Work(ops=ops, bytes=nbytes, solves=self.B * self.steps)

    def reference_run(self, seeds, k, dtype):
        inputs = self.ref.sweep_inputs(self.exp, self.arrays, seeds,
                                       self.params["mass"], self.C, dtype)
        arrays = dict(self.arrays, theta0=self.arrays["init_policies"],
                      locs0=self.arrays["prior_locs"])
        return self.ref.sweep_reference(self.cfg, arrays, inputs, k,
                                        self.steps, dtype=dtype), inputs

    def first_step_gaps(self, got, want, measure):
        return {
            "pos": measure(_pair(got, "px", "py"), _pair(want, "px", "py")),
            "vel": measure(_pair(got, "vx", "vy"), _pair(want, "vx", "vy")),
            "action": measure(_pair(got, "a_x", "a_y"),
                              _pair(want, "a_x", "a_y")),
            "cost": measure(got["cost"], want["cost"]),
            "bw_sv": measure(got["bw_sv"], want["bw_sv"]),
        }

    def physics(self, logs, eps):
        state = torch.stack([logs[f] for f in ("px", "py", "vx", "vy")],
                            dim=-1)
        action = _pair(logs, "a_x", "a_y")
        done = logs["done"]
        s0 = self.arrays["init_state"].expand(self.B, 1, 4)
        prev = torch.cat([s0, state[:, :-1]], dim=1)
        done_prev = torch.cat([torch.zeros_like(done[:, :1]), done[:, :-1]],
                              dim=1)
        t = torch.arange(done.shape[1], device=self.device)
        load = float(self.exp["extra_load"]) * (
            t >= self.steps // 4).to(torch.float32)
        mass = eps["base_mass"][:, None] + load
        moved = self.ref.simulate(prev, action, mass, self.cfg)
        want = torch.where(done_prev[..., None] > 0.5, prev, moved)
        cost, ended = self.ref.state_cost(want, self.cfg)
        want_done = torch.maximum(done_prev, ended.to(done.dtype))
        return {"sim_state": gap(state, want),
                "sim_cost": gap(logs["cost"], cost),
                "sim_done": float((done != want_done).sum())}

    def chain_gaps(self, logs, out, control):
        """The final MPF particles against the MPF alone over the logged
        episodes (their response to the load included)."""
        want = self.ref.mpf_chain(self.cfg, self.arrays, logs)
        if control:
            got = self.ref.mpf_chain(self.cfg, self.arrays, logs,
                                     dtype=torch.bfloat16).to(torch.float32)
        else:
            got = out["mpf_x"].reshape(self.B, -1)
        return {"chain_mpf_x": gap(got, want)}
