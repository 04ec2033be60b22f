"""Closed-loop MPC episode harness (counterpart of
`dust_tpu/simulation.py:PendulumSimulation`).

One MPC step: SVMPC optimize -> (after warm-up) forward and select ->
simulator step -> MPF optimize, logged per step. The simulator is the
dynamics model itself with the episode's true parameters (gym
`Pendulum-v0` dynamics == `PendulumModel.step` with g=10). Where the JAX
harness scans and branches on device, this one is a Python loop over
steps with `if t >= warm_up`; the logs stay on the device until the
episode ends.

When MPF is active, rollout parameters are drawn from the *current* MPF
prior each step.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.pendulum import PendulumModel

COLUMNS = (
    "Cost", "Position", "Speed", "Actions", "Timestep", "Iteration",
    "DynParticles", "DynBandwidths", "PolParticles", "Weights",
    "ExpParams", "AvgCumCost",
)


class PendulumSimulation:
    """Multi-episode pendulum harness."""

    def __init__(self, controller, svmpc=None, mpf=None, model=None,
                 sim_g=10.0, sim_dt=0.05, steps=200, warm_up=1,
                 use_svmpc=True, disco_strategy="average", mpf_bw=None,
                 mpf_steps=None, use_exact_model=False, device="cuda"):
        self.device = resolve_device(device)
        self.controller = controller
        self.svmpc = svmpc
        self.mpf = mpf
        self.model = model  # internal rollout model
        self.sim_model = PendulumModel(g=sim_g, dt=sim_dt)
        self.steps = int(steps)
        self.warm_up = int(warm_up)
        self.use_svmpc = bool(use_svmpc)
        self.disco_strategy = disco_strategy
        self.mpf_bw = mpf_bw          # None -> per-step Silverman
        self.mpf_steps = mpf_steps    # None -> mpf.n_steps
        # exact-model baselines: the controller rolls out under the
        # episode's true parameters
        self.use_exact_model = bool(use_exact_model)

    def step_fn(self, static_dyn_dist):
        """The per-step function
        (carry, t, true_params) -> (carry, log), with carry =
        (generator, obs [1, S], dstate, svstate, mstate) and log =
        (obs, action, cost, theta, weights, dyn_particles, bw)."""
        ctrl, svmpc, mpf = self.controller, self.svmpc, self.mpf
        dev = self.device

        def step(carry, t, true_params):
            generator, obs, dstate, svstate, mstate = carry
            dyn_dist = mstate.prior if mpf is not None else static_dyn_dist

            if self.use_svmpc:
                svstate, dstate, costs = svmpc.optimize(
                    svstate, dstate, obs, dyn_dist, generator
                )
                if t >= self.warm_up:
                    svstate, a_seq, weights = svmpc.forward(
                        svstate, costs, generator=generator
                    )
                    action = a_seq[0]
                else:
                    action = torch.zeros((ctrl.dim_a,), device=dev)
                    weights = torch.full((svmpc.n_particles,), float("nan"),
                                         device=dev)
            else:
                override = (
                    {k: v for k, v in true_params.items()
                     if k in self.model.params_dict}
                    if self.use_exact_model else None
                )
                dstate, _, _, _, _, _ = ctrl.forward(
                    dstate, obs, self.model, dyn_dist, generator,
                    params_override=override,
                )
                dstate, next_actions = ctrl.step(
                    dstate, strategy=self.disco_strategy
                )
                action = next_actions.reshape(-1)
                weights = dstate.a_mix

            obs = self.sim_model.step(obs, action[None], true_params)

            if mpf is not None:
                mstate, _, bw = mpf.optimize(
                    mstate, action, obs[0], bw=self.mpf_bw,
                    n_steps=self.mpf_steps,
                )
            else:
                bw = 0.0

            cost = ctrl.inst_cost_fn(obs)[0]
            theta_log = (
                svstate.theta if self.use_svmpc
                else torch.zeros((ctrl.n_pol, ctrl.hz_len, ctrl.dim_a),
                                 device=dev)
            )
            dyn_log = mstate.x if mpf is not None else torch.zeros(
                (1, 1), device=dev)
            bw = torch.as_tensor(bw, dtype=torch.float32, device=dev)
            log = (obs[0], action, cost, theta_log, weights, dyn_log, bw)
            return (generator, obs, dstate, svstate, mstate), log

        return step

    def episode_fn(self, static_dyn_dist):
        """(generator, true_params, init_obs, dstate, svstate, mstate) ->
        (carry, logs), logs stacked over steps on the device."""
        step = self.step_fn(static_dyn_dist)

        def episode(generator, true_params, init_obs, dstate, svstate,
                    mstate):
            carry = (generator, init_obs, dstate, svstate, mstate)
            logs = []
            for t in range(self.steps):
                carry, log = step(carry, t, true_params)
                logs.append(log)
            return carry, tuple(torch.stack(col) for col in zip(*logs))

        return episode

    def run(self, generator, experiment_params, init_state, init_policies,
            policies_prior=None, dyn_dist=None, mpf_init=None,
            episodes=None, verbose=False):
        """Run one episode per entry of `experiment_params` (list of dicts
        of true simulator parameters). Returns the reference-schema columns
        (`COLUMNS`) as numpy arrays over all episodes' steps; see
        `to_dataframe`."""
        episodes = len(experiment_params) if episodes is None else episodes
        episode = self.episode_fn(dyn_dist)
        init_obs = torch.as_tensor(init_state, dtype=torch.float32,
                                   device=self.device).reshape(1, -1)
        parts = []
        for i in range(episodes):
            true = experiment_params[i]
            true_params = {
                k: torch.tensor(v, dtype=torch.float32, device=self.device)
                for k, v in true.items()
            }
            dstate = self.controller.init_state(init_policies)
            svstate = (
                self.svmpc.init_state(init_policies, policies_prior)
                if self.use_svmpc else ()
            )
            mstate = (
                self.mpf.init_state(mpf_init, init_obs[0],
                                    self.controller.dim_a)
                if self.mpf is not None else ()
            )
            _, logs = episode(generator, true_params, init_obs, dstate,
                              svstate, mstate)
            states, actions, costs, thetas, weights, dyn_parts, bws = (
                col.detach().cpu().numpy() for col in logs
            )
            if verbose:
                print(f"episode {i}: params={true} "
                      f"final avg cost={costs[-20:].mean():.3f}")
            timestep = np.arange(self.steps)
            parts.append({
                "Cost": costs,
                "Position": states[:, 0],
                "Speed": states[:, 1],
                "Actions": actions[:, 0],
                "Timestep": timestep,
                "Iteration": np.full(self.steps, i),
                "DynParticles": dyn_parts if self.mpf is not None else None,
                "DynBandwidths": bws,
                "PolParticles": thetas[..., 0, 0],
                "Weights": weights,
                "ExpParams": np.tile(
                    np.asarray(list(true.values()), dtype=np.float64),
                    (self.steps, 1),
                ),
                "AvgCumCost": np.round(np.cumsum(costs) / (timestep + 1), 2),
            })
        return {
            name: (None if parts[0][name] is None
                   else np.concatenate([p[name] for p in parts]))
            for name in COLUMNS
        }


def to_dataframe(columns):
    """The columns `PendulumSimulation.run` returns as a pandas DataFrame
    in the reference schema (index = timestep; array-valued cells as
    per-row lists)."""
    import pandas as pd

    n = len(columns["Cost"])
    data = {}
    for name in COLUMNS:
        col = columns[name]
        if col is None:
            data[name] = None
        elif name == "DynParticles":
            data[name] = list(col)
        elif col.ndim > 1:
            data[name] = col.tolist()
        else:
            data[name] = col
    return pd.DataFrame(index=list(columns["Timestep"][:n]), data=data)
