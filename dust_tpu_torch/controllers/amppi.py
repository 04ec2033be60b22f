"""AMPPI: single-policy MPPI controller (counterpart of
`dust_tpu/controllers/amppi.py`).

Functions over an explicit `AMPPIState`. The reference's cost indexing
differs from DISCO's on purpose: the instantaneous costs run over
states[1:] (the initial state excluded, the final one included).

Parameter-handling modes (`params_sampling`):
  * "none" (or a false value) — nominal model parameters
  * "single"   — one draw from the dynamics distribution, shared by every
                 rollout
  * "extended" — one draw per rollout
  * a `MerweScaledUTF` — the sigma points of the dynamics distribution,
                 the costs weighted over them
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..device import resolve_device
from ..utils.utf import MerweScaledUTF
from .disco import _dist_moments


@dataclass(frozen=True)
class AMPPIState:
    a_seq: torch.Tensor  # [H, A]


class AMPPI:
    def __init__(
        self,
        observation_space,
        action_space,
        hz_len,
        n_samples,
        lambda_=1.0,
        a_cov=None,
        inst_cost_fn=None,
        term_cost_fn=None,
        params_sampling="extended",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.hz_len = int(hz_len)
        self.dim_s = observation_space.dim
        self.dim_a = action_space.dim
        self.min_a = torch.as_tensor(action_space.low, device=self.device)
        self.max_a = torch.as_tensor(action_space.high, device=self.device)
        self.n_samples = int(n_samples)
        self.lambda_ = float(lambda_)

        if inst_cost_fn is None and term_cost_fn is None:
            raise ValueError("Specify at least one cost function")
        _null = lambda s, *a, **k: torch.zeros(s.shape[:-1], dtype=s.dtype,
                                               device=s.device)
        self.inst_cost_fn = inst_cost_fn or _null
        self.term_cost_fn = term_cost_fn or _null

        if a_cov is None:
            a_cov = torch.eye(self.dim_a)
        a_cov = torch.as_tensor(a_cov, dtype=torch.float32,
                                device=self.device)
        self.a_scale_tril = torch.linalg.cholesky(a_cov)
        self.a_pre = torch.linalg.inv(a_cov)

        self._tf = None
        if isinstance(params_sampling, MerweScaledUTF):
            self._params_shape = None
            self._tf = params_sampling
        elif not params_sampling or params_sampling == "none":
            self._params_shape = None
        elif params_sampling == "single":
            self._params_shape = 1
        elif params_sampling == "extended":
            self._params_shape = self.n_samples
        else:
            raise ValueError(
                f"Invalid value for 'params_sampling': {params_sampling}"
            )
        self.params_sampling = params_sampling

    def init_state(self, init_actions=None) -> AMPPIState:
        if init_actions is None:
            a_seq = torch.zeros((self.hz_len, self.dim_a), device=self.device)
        else:
            a_seq = torch.as_tensor(init_actions, dtype=torch.float32,
                                    device=self.device)
        return AMPPIState(a_seq=a_seq)

    def _rollout(self, state, model, acts, params, generator):
        """acts [..., H, A] -> states [..., H+1, S] (initial included)."""
        s = state.expand(*acts.shape[:-2], self.dim_s)
        traj = [s]
        for t in range(self.hz_len):
            s = model.step(s, acts[..., t, :], params, generator=generator)
            traj.append(s)
        return torch.stack(traj, dim=-2)

    def update_actions(self, astate: AMPPIState, state, model,
                       params_dist=None, generator=None, ext_actions=None,
                       eps_noise=None):
        """One MPPI update. Returns (new_astate, costs, states, acts,
        omega). `eps_noise` injects the action noise in place of the
        internal N(0, a_cov) draw; `ext_actions` gives the actions
        themselves."""
        if ext_actions is None:
            if eps_noise is not None:
                eps = eps_noise
            else:
                z = torch.randn((self.n_samples, self.hz_len, self.dim_a),
                                generator=generator, device=self.device)
                eps = z @ self.a_scale_tril.T
            acts = eps + astate.a_seq
        else:
            acts = ext_actions
            eps = acts - astate.a_seq

        utf_weights = None
        if self._tf is not None:
            mean, cov = _dist_moments(params_dist)
            sp = self._tf.compute_sigma_points(mean, cov)
            pts = self._tf.pts
            params = {
                k: sp[i].reshape(pts, 1, 1)
                for i, k in enumerate(model.uncertain_params)
            }
            utf_weights, _ = self._tf.weights(sp.device)
            batched = acts.unsqueeze(0).expand(pts, *acts.shape)
            states = self._rollout(state, model, batched, params, generator)
        elif self._params_shape is not None and params_dist is not None:
            draws = params_dist.sample(generator, (self._params_shape,))
            draws = draws.reshape(self._params_shape, -1)
            # [n, 1] columns against the [n_samples, S] rollout batch
            # ('single': n = 1 shared; 'extended': one per rollout)
            params = {
                k: draws[:, i].reshape(-1, 1)
                for i, k in enumerate(model.uncertain_params)
            }
            states = self._rollout(state, model, acts, params, generator)
        else:
            states = self._rollout(state, model, acts, None, generator)

        tail = states[..., 1:, :]
        inst = self.inst_cost_fn(
            tail, acts.expand(*tail.shape[:-1], self.dim_a)
        ).sum(dim=-1)
        term = self.term_cost_fn(states[..., -1, :])
        if utf_weights is not None:
            inst = torch.tensordot(utf_weights, inst, dims=([0], [0]))
            term = torch.tensordot(utf_weights, term, dims=([0], [0]))
        ctrl = self.lambda_ * torch.einsum(
            "ta,ita->i", astate.a_seq @ self.a_pre, eps
        )
        costs = term + inst + ctrl

        beta = costs.min()
        omega = torch.softmax(-(costs - beta) / self.lambda_, dim=0)
        a_seq = astate.a_seq + torch.tensordot(omega, eps, dims=1)
        a_seq = torch.clamp(a_seq, self.min_a, self.max_a)
        return replace(astate, a_seq=a_seq), costs, states, acts, omega

    def roll(self, astate: AMPPIState, steps=1):
        """Shift the plan forward by `steps`, zero-filling the tail."""
        a_seq = torch.roll(astate.a_seq, -steps, dims=0)
        a_seq[-steps:] = 0.0
        return replace(astate, a_seq=a_seq)
