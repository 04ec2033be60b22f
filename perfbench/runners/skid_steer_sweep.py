"""The skid-steer's sweep (K15, `skid_steer_episode.cu`):
`MegakernelGroupSweep` over `megakernel_skid_steer_sweep_fn`, true (x_icr,
wheel_radius, axial_distance) per scenario, x_icr times `extra_load` from
a quarter of the episode on. The run's policy prior and initial policies
are the harness's draws (`common.draw_arrays`, a standard normal as the
particle's) times the configuration's `init_policy_scale`, for the program
and the reference alike."""

from __future__ import annotations

import torch

from perfbench import skid_steer_counts
from perfbench.common import Sweep, Work, gap, program_arrays


def _stack(d, *keys):
    return torch.stack([d[k] for k in keys], dim=-1)


class Runner(Sweep):
    OUTCOME = ("cost", "done")

    def adapter(self, cfg, arrays):
        from dust_tpu_torch.experiments import assemble_particle_stack
        from dust_tpu_torch.simulation import megakernel_skid_steer_sweep_fn

        scale = float(cfg["exp_params"]["init_policy_scale"])
        for k in ("prior_locs", "init_policies"):
            self.arrays[k] = self.arrays[k] * scale
        arrays = program_arrays(self.cfg, self.arrays)
        stack = assemble_particle_stack(cfg, arrays, device=self.device)
        return megakernel_skid_steer_sweep_fn(
            stack, cfg["exp_params"], steps=self.steps, n_sc=self.n_sc,
            n_chains=self.C)

    def work(self, outcome):
        """The MPF skips the steps after an episode has ended."""
        done = outcome[1]                      # [G, (C,) steps, n_sc]
        ended = float(done.movedim(-2, -1)[..., :-1].sum())
        updates = self.B * self.steps - ended
        ops, nbytes = skid_steer_counts.skid_steer_work(
            self.exp, self.cfg["env_params"], self.steps, updates, self.B)
        return Work(ops=ops, bytes=nbytes, solves=self.B * self.steps)

    def reference_run(self, seeds, k, dtype):
        inputs = self.ref.sweep_inputs(
            self.exp, self.arrays, seeds, self.params["x_icr"],
            self.params["wheel_radius"], self.params["axial_distance"],
            self.C, dtype)
        arrays = dict(self.arrays, theta0=self.arrays["init_policies"],
                      locs0=self.arrays["prior_locs"])
        return self.ref.sweep_reference(self.cfg, arrays, inputs, k,
                                        self.steps, dtype=dtype), inputs

    def first_step_gaps(self, got, want, measure):
        return {
            "pos": measure(_stack(got, "x", "y"), _stack(want, "x", "y")),
            "th": measure(got["th"], want["th"]),
            "speed": measure(_stack(got, "v", "omega"),
                             _stack(want, "v", "omega")),
            "action": measure(_stack(got, "a_r", "a_l"),
                              _stack(want, "a_r", "a_l")),
            "cost": measure(got["cost"], want["cost"]),
            "bw_sv": measure(got["bw_sv"], want["bw_sv"]),
        }

    def physics(self, logs, inputs):
        """Every logged step's state, cost and termination re-done from
        the state before it (the initial state at the first) and the
        logged action, the state frozen once done."""
        states = _stack(logs, *self.ref.LOG_FIELDS[:5])
        action = _stack(logs, "a_r", "a_l")
        done = logs["done"]
        T = states.shape[1]
        s0 = self.arrays["init_state"].to(states.dtype).expand(self.B, 1, 5)
        prev = torch.cat([s0, states[:, :-1]], dim=1)
        done_prev = torch.cat([torch.zeros_like(done[:, :1]), done[:, :-1]],
                              dim=1)
        t = torch.arange(T, device=states.device)
        moved = self.ref.simulate(prev, action,
                                  inputs["params"].to(states.dtype),
                                  self.cfg, t, self.steps)
        want = torch.where(done_prev[..., None] > 0.5, prev, moved)
        cost, ended = self.ref.state_cost(want, self.cfg)
        want_done = torch.maximum(done_prev, ended.to(done.dtype))
        return {"sim_state": gap(states, want),
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
            got = out["mpf_x"].reshape(self.B, -1, 3)
        return {"chain_mpf_x": gap(got, want)}
