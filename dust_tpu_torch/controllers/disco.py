"""Multi-policy DISCO / MPPI controller (counterpart of
`dust_tpu/controllers/disco.py`).

The controller is a static object whose methods are functions over an
explicit `DiscoState`; the rollout loops `model.step` over the horizon for
a shaped [n_params, n_actions, n_pol] batch, in which one sampled
parameter set broadcasts over its whole block of rollouts.

Parameter-handling modes:
  * none     — nominal model parameters (or `params_override`)
  * sampled  — `n_params` draws from the dynamics distribution per call
  * utf      — not ported yet (ROADMAP Queue 1 item 9); raises.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device


@dataclass(frozen=True)
class DiscoState:
    """Planned sequence, per-policy plans and mixture weights."""

    a_seq: torch.Tensor  # [H, A]
    a_mat: torch.Tensor  # [P, H, A]
    a_mix: torch.Tensor  # [P]


class MultiDisco:
    def __init__(
        self,
        observation_space,
        action_space,
        hz_len,
        n_policies,
        action_samples,
        temperature=1.0,
        ctrl_penalty=1.0,
        a_cov=None,
        inst_cost_fn=None,
        term_cost_fn=None,
        params_sampling=True,
        params_samples=4,
        params_log_space=False,
        fused_state_costs=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.hz_len = int(hz_len)
        self.dim_s = observation_space.dim
        self.dim_a = action_space.dim
        self.min_a = torch.as_tensor(action_space.low, device=self.device)
        self.max_a = torch.as_tensor(action_space.high, device=self.device)
        self.n_pol = int(n_policies)
        self.n_actions = int(action_samples)
        self.temp = float(temperature)
        self.a_reg = float(temperature) * (1.0 - float(ctrl_penalty))

        if inst_cost_fn is None and term_cost_fn is None:
            raise ValueError("Specify at least one cost function")
        _null = lambda s, *a, **k: torch.zeros(s.shape[:-1], dtype=s.dtype,
                                               device=s.device)
        self.inst_cost_fn = inst_cost_fn or _null
        self.term_cost_fn = term_cost_fn or _null

        if a_cov is None:
            a_cov = torch.eye(self.dim_a)
        self.a_cov = torch.as_tensor(a_cov, dtype=torch.float32,
                                     device=self.device)
        self.a_scale_tril = torch.linalg.cholesky(self.a_cov)
        self.a_pre = torch.linalg.inv(self.a_cov)

        self._params_log_space = bool(params_log_space)
        if params_sampling in (False, None, "none"):
            self.n_params = 1
            self._params_mode = "none"
        elif params_sampling is True:
            self.n_params = int(params_samples)
            self._params_mode = "sampled"
        elif params_sampling == "utf" or hasattr(params_sampling,
                                                 "compute_sigma_points"):
            raise NotImplementedError(
                "MultiDisco UTF sigma-point mode is not ported yet "
                "(ROADMAP Queue 1 item 9)"
            )
        else:
            raise ValueError(
                f"Invalid value for 'params_sampling': {params_sampling}"
            )
        self.n_rollouts = self.n_params * self.n_actions * self.n_pol
        # optional fused rollout+state-cost hook (the pendulum CUDA kernel,
        # `ops/rollout.py`): (state, actions [I, P, H, A], params dict|None)
        # -> state costs [I, P]; trajectories are then never materialized
        self.fused_state_costs = fused_state_costs

    # -- state ------------------------------------------------------------

    def init_state(self, init_actions=None) -> DiscoState:
        a_seq = torch.zeros((self.hz_len, self.dim_a), device=self.device)
        if init_actions is None:
            a_mat = torch.zeros((self.n_pol, self.hz_len, self.dim_a),
                                device=self.device)
        else:
            a_mat = torch.as_tensor(init_actions, dtype=torch.float32,
                                    device=self.device)
            if a_mat.shape != (self.n_pol, self.hz_len, self.dim_a):
                raise ValueError("Initial actions shape mismatch.")
        return DiscoState(a_seq=a_seq, a_mat=a_mat,
                          a_mix=torch.ones(self.n_pol, device=self.device))

    # -- sampling helpers -------------------------------------------------

    def sample_eps(self, generator, shape=None):
        """Action-noise draws from N(0, a_cov) with the given leading shape
        (default [n_actions, n_pol, hz_len]) -> [..., dim_a]."""
        if shape is None:
            shape = (self.n_actions, self.n_pol, self.hz_len)
        z = torch.randn((*shape, self.dim_a), generator=generator,
                        device=self.device)
        return z @ self.a_scale_tril.T

    def _sample_params(self, generator, model, params_dist):
        """n_params draws -> (params dict of [n_params, 1, 1, 1] columns,
        log_probs [n_params])."""
        draws = params_dist.sample(generator, (self.n_params,))
        params_log_p = params_dist.log_prob(draws)
        if self._params_log_space:
            draws = torch.exp(draws)
        draws = draws.reshape(self.n_params, -1)
        params = {
            k: draws[:, i].reshape(self.n_params, 1, 1, 1)
            for i, k in enumerate(model.uncertain_params)
        }
        return params, params_log_p

    # -- rollout ----------------------------------------------------------

    def rollout(self, state, model, actions, params=None, generator=None):
        """Step `model` over the horizon for a shaped batch of action
        sequences: actions [..., H, A], state broadcastable to [..., S].
        Returns states [..., H+1, S] (initial state included)."""
        batch_shape = actions.shape[:-2]
        s = state.expand(*batch_shape, self.dim_s)
        traj = [s]
        for t in range(self.hz_len):
            s = model.step(s, actions[..., t, :], params, generator=generator)
            traj.append(s)
        return torch.stack(traj, dim=-2)

    # -- cost -------------------------------------------------------------

    def compute_cost(self, dstate: DiscoState, states, actions):
        """states [n_params, n_actions, n_pol, H+1, S], actions
        [n_actions, n_pol, H, A] -> costs [n_actions, n_pol]. The control
        penalty derives its eps from the planned sequence (actions -
        a_seq)."""
        head = states[..., :-1, :]
        inst = self.inst_cost_fn(
            head, actions.expand(*head.shape[:-1], self.dim_a)
        )
        term = self.term_cost_fn(states[..., -1, :])
        state_cost = (inst.sum(dim=-1) + term).mean(dim=0)
        return state_cost + self._ctrl_penalty(dstate, actions)

    def _ctrl_penalty(self, dstate: DiscoState, actions):
        """a_reg * sum_{t,a} -eps_ctrl * (a_mat @ a_pre), computed even when
        a_reg == 0."""
        eps_ctrl = actions - dstate.a_seq
        m = dstate.a_mat @ self.a_pre  # [P, H, A]
        return self.a_reg * torch.einsum("ipta,pta->ip", -eps_ctrl, m)

    # -- forward ----------------------------------------------------------

    def forward(self, dstate: DiscoState, state, model, params_dist=None,
                generator=None, ext_actions=None, eps_noise=None,
                params_override=None):
        """One controller update. Returns
        (new_dstate, costs, states, actions, omega, params_log_p).

        `eps_noise` injects the exact action noise in place of the internal
        N(0, a_cov) draw; `params_override` (nominal-params mode only) rolls
        out under those dynamics parameters."""
        if ext_actions is None:
            eps = (eps_noise if eps_noise is not None
                   else self.sample_eps(generator))
            actions = eps + dstate.a_mat  # [n_actions, n_pol, H, A]
        else:
            actions = ext_actions
            eps = actions - dstate.a_seq

        if self._params_mode == "sampled":
            params, params_log_p = self._sample_params(generator, model,
                                                       params_dist)
            batched = actions.unsqueeze(0).expand(self.n_params,
                                                  *actions.shape)
        else:
            params, params_log_p = params_override, None
            batched = actions.unsqueeze(0)

        if self.fused_state_costs is not None:
            # fused rollout+cost kernel: trajectories never materialize
            state_cost = self.fused_state_costs(state, actions, params)
            costs = state_cost + self._ctrl_penalty(dstate, actions)
            states = None
        else:
            states = self.rollout(state, model, batched, params,
                                  generator=generator)
            costs = self.compute_cost(dstate, states, actions)

        # softmax weighting: per-policy normalizer over the action-sample
        # axis, max-subtracted by the global minimum cost
        beta = costs.min()
        log_costs = -(costs - beta) / self.temp
        eta = torch.logsumexp(log_costs, dim=0)             # [P]
        omega = torch.exp(log_costs - eta)                  # [n_actions, P]
        delta = torch.einsum("ip,ipta->pta", omega, eps)
        new_state = replace(
            dstate,
            a_mat=dstate.a_mat + delta,
            a_mix=torch.exp(eta - torch.logsumexp(eta, dim=0)),
        )
        return new_state, costs, states, actions, omega, params_log_p

    # -- step -------------------------------------------------------------

    def step(self, dstate: DiscoState, strategy="argmax", steps=1,
             ext_actions=None):
        """Pick the executed sequence, clip, and roll the plan. Returns
        (new_dstate, next_actions [steps, A]). `a_mat` is left unclipped."""
        if strategy == "argmax":
            a_seq = dstate.a_mat[torch.argmax(dstate.a_mix)]
        elif strategy == "average":
            a_seq = torch.einsum("p,pta->ta", dstate.a_mix, dstate.a_mat)
        elif strategy == "external" and ext_actions is not None:
            a_seq = torch.as_tensor(ext_actions, dtype=torch.float32,
                                    device=self.device)
        else:
            raise ValueError("Invalid value for strategy.")
        a_seq = torch.clamp(a_seq, self.min_a, self.max_a)
        next_actions = a_seq[:steps]
        a_seq = torch.roll(a_seq, -steps, dims=0)
        a_seq[-steps:] = 0.0
        a_mat = torch.roll(dstate.a_mat, -steps, dims=1)
        a_mat[:, -steps:] = 0.0
        return replace(dstate, a_seq=a_seq, a_mat=a_mat), next_actions
