"""The cart-pole's sweep (K14, `cartpole_episode.cu`): `MegakernelGroupSweep`
over `megakernel_cartpole_sweep_fn`, true (length, mass_pole) per scenario,
the pole mass doubled from the configuration's `load_step` on."""

from __future__ import annotations

import torch

from perfbench import cartpole_counts
from perfbench.common import Sweep, Work, gap


class Runner(Sweep):
    OUTCOME = ("cost",)

    def adapter(self, cfg, arrays):
        from dust_tpu_torch.experiments import assemble_stack
        from dust_tpu_torch.simulation import megakernel_cartpole_sweep_fn

        stack = assemble_stack(cfg, arrays, case=self.config["case"],
                               device=self.device)
        return megakernel_cartpole_sweep_fn(
            stack, cfg["exp_params"], steps=self.steps, n_sc=self.n_sc,
            n_chains=self.C)

    def work(self, outcome):
        ops, nbytes = cartpole_counts.cartpole_work(self.exp, self.steps,
                                                    self.B)
        return Work(ops=ops, bytes=nbytes, solves=self.B * self.steps)

    def reference_run(self, seeds, k, dtype):
        inputs = self.ref.sweep_inputs(
            self.exp, self.arrays, seeds, self.params["length"],
            self.params["mass_pole"], self.C, dtype)
        arrays = dict(self.arrays, theta0=self.arrays["init_policies"],
                      locs0=self.arrays["prior_locs"])
        return self.ref.sweep_reference(self.cfg, arrays, inputs, k,
                                        dtype=dtype), inputs

    def first_step_gaps(self, got, want, measure):
        return {f: measure(got[f], want[f]) for f in want}

    def physics(self, logs, inputs):
        """Every logged step's state and cost re-done from the state
        before it (the initial state at the first) and the logged
        action."""
        fields = self.ref.LOG_FIELDS[:4]
        states = torch.stack([logs[f] for f in fields], dim=-1)
        T = states.shape[1]
        s0 = self.arrays["init_state"].to(states.dtype).expand(self.B, 1, 4)
        prev = torch.cat([s0, states[:, :-1]], dim=1)
        t = torch.arange(T, device=states.device)
        want, cost = self.ref.simulate(
            self.cfg, prev, logs["action"], inputs["length"][:, None],
            inputs["mass_pole"][:, None], t)
        return {"sim_state": gap(states, want),
                "sim_cost": gap(logs["cost"], cost)}

    def chain_gaps(self, logs, out, control):
        """Every logged step's MPF bandwidth and the final MPF particles
        against the MPF alone over the logged episodes."""
        want_bw, want_x = self.ref.mpf_chain(self.cfg, self.arrays, logs)
        if control:
            got_bw, got_x = (v.to(torch.float32) for v in self.ref.mpf_chain(
                self.cfg, self.arrays, logs, dtype=torch.bfloat16))
        else:
            got_bw = logs["bw_mpf"]
            got_x = out["mpf_x"].reshape(self.B, -1, 2)
        return {"chain_bw_mpf": gap(got_bw, want_bw),
                "chain_mpf_x": gap(got_x, want_x)}
