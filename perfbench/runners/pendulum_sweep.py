"""The pendulum's sweep (K5, `pendulum_episode.cu`): `MegakernelGroupSweep`
over `megakernel_pendulum_sweep_fn`, true (length, mass) per scenario."""

from __future__ import annotations

import torch

from perfbench import counts
from perfbench.common import Sweep, Work, gap


class Runner(Sweep):
    OUTCOME = ("cost",)

    def adapter(self, cfg, arrays):
        from dust_tpu_torch.experiments import assemble_stack
        from dust_tpu_torch.simulation import megakernel_pendulum_sweep_fn

        stack = assemble_stack(cfg, arrays, case=self.config["case"],
                               device=self.device)
        return megakernel_pendulum_sweep_fn(
            stack, cfg["exp_params"], steps=self.steps, n_sc=self.n_sc,
            n_chains=self.C)

    def work(self, outcome):
        ops, nbytes = counts.pendulum_work(self.exp, self.steps, self.B)
        return Work(ops=ops, bytes=nbytes, solves=self.B * self.steps)

    def reference_run(self, seeds, k, dtype):
        inputs = self.ref.sweep_inputs(
            self.exp, self.arrays, seeds, self.params["length"],
            self.params["mass"], self.C, dtype)
        arrays = dict(self.arrays, theta0=self.arrays["init_policies"],
                      locs0=self.arrays["prior_locs"])
        return self.ref.sweep_reference(self.exp, arrays, inputs, k,
                                        dtype=dtype), inputs

    def first_step_gaps(self, got, want, measure):
        return {f: measure(got[f], want[f]) for f in want}

    def physics(self, logs, eps):
        th, om, action, cost = (logs[f] for f in ("th", "om", "action",
                                                  "cost"))
        s0 = self.arrays["init_state"]
        th_prev = torch.cat([s0[0].expand(self.B, 1), th[:, :-1]], dim=1)
        om_prev = torch.cat([s0[1].expand(self.B, 1), om[:, :-1]], dim=1)
        th2, om2, c2 = self.ref.simulate(th_prev, om_prev, action,
                                         eps["il"][:, None],
                                         eps["im"][:, None])
        return {"sim_th": gap(th, th2), "sim_om": gap(om, om2),
                "sim_cost": gap(cost, c2)}

    def chain_gaps(self, logs, out, control):
        """Every logged step's MPF bandwidth and the final MPF particles
        against the MPF alone over the logged episodes."""
        want_bw, want_x = self.ref.mpf_chain(self.exp, self.arrays, logs)
        if control:
            got_bw, got_x = (v.to(torch.float32) for v in self.ref.mpf_chain(
                self.exp, self.arrays, logs, dtype=torch.bfloat16))
        else:
            got_bw = logs["bw_mpf"]
            got_x = out["mpf_x"].reshape(self.B, -1, 2)
        return {"chain_bw_mpf": gap(got_bw, want_bw),
                "chain_mpf_x": gap(got_x, want_x)}

