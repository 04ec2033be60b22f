"""Likelihood models for the dual Stein inference loop (counterpart of
`dust_tpu/inference/likelihoods.py`).

* `GaussianLikelihood` — the MPF observation model: predict one step of the
  dynamics from the previous observation under each particle's parameters
  and score the new observation under an isotropic Gaussian.
* `CostLikelihood` + `ExpectedCost` / `ExponentiatedUtility` — the control
  pseudo-likelihood over the controller's batched rollout costs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class LikelihoodState:
    """Conditioning state of the Gaussian observation likelihood."""

    loc: torch.Tensor          # latest observation [S]
    past_obs: torch.Tensor     # previous observation [S]
    past_action: torch.Tensor  # action taken at past_obs [A]


class GaussianLikelihood:
    """Observation model for MPF."""

    def __init__(self, obs_std, model, log_space=False):
        self.sigma = float(obs_std)
        self.model = model
        self.log_space = bool(log_space)

    def init_state(self, initial_obs, dim_a) -> LikelihoodState:
        initial_obs = torch.as_tensor(initial_obs,
                                      dtype=torch.float32).reshape(-1)
        return LikelihoodState(
            loc=initial_obs,
            past_obs=torch.zeros_like(initial_obs),
            past_action=torch.zeros((dim_a,), device=initial_obs.device),
        )

    def condition(self, lik_state: LikelihoodState, action, new_obs):
        """Re-center on the newest observation; the old center becomes the
        prediction start."""
        return LikelihoodState(
            loc=new_obs.reshape(-1),
            past_obs=lik_state.loc,
            past_action=action.reshape(-1),
        )

    def sample(self, lik_state: LikelihoodState, theta):
        """One-step prediction from past_obs under each particle's
        parameters: theta [n, P] -> states [n, S]. Differentiable w.r.t.
        theta."""
        params = torch.exp(theta) if self.log_space else theta
        params_dict = self.model.params_to_dict(params)
        n = theta.shape[0]
        states = lik_state.past_obs.expand(n, lik_state.past_obs.shape[0])
        return self.model.step(states, lik_state.past_action, params_dict)

    def log_prob(self, lik_state: LikelihoodState, samples):
        """log N(samples | loc, sigma^2 I) -> [n]."""
        d = lik_state.loc.shape[0]
        z = (samples - lik_state.loc) / self.sigma
        return -0.5 * (
            (z * z).sum(dim=-1) + d * math.log(2 * math.pi * self.sigma**2)
        )


class CostLikelihood:
    """Control pseudo-likelihood: rollout + cost via the controller, for
    `n_samples` action sequences drawn around each policy particle from
    N(theta, a_cov)."""

    def __init__(self, n_samples, controller, model):
        self.n_samples = int(n_samples)
        self.controller = controller
        self.model = model

    def sample(self, dstate, theta, state, params_dist, generator,
               noise=None):
        """Returns (new_dstate, costs [n_samples, m], actions
        [n_samples, m, H, A], states, params_log_p). `noise` optionally
        injects the standard-normal draw."""
        m, h, a = theta.shape
        if noise is None:
            noise = torch.randn((self.n_samples, m, h, a),
                                generator=generator, device=theta.device)
        actions = theta + noise @ self.controller.a_scale_tril.T
        new_dstate, costs, states, actions, _, params_log_p = (
            self.controller.forward(
                dstate, state, self.model, params_dist, generator,
                ext_actions=actions,
            )
        )
        return new_dstate, costs, actions, states, params_log_p

    def log_prob(self, costs):
        raise NotImplementedError


class ExpectedCost(CostLikelihood):
    """log p ~ -alpha * mean(costs)."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def log_prob(self, costs):
        return -self.alpha * costs.mean(dim=0)


class ExponentiatedUtility(CostLikelihood):
    """log p ~ logsumexp(-alpha * costs) - log N."""

    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self.alpha = float(alpha)

    def log_prob(self, costs):
        return (torch.logsumexp(-self.alpha * costs, dim=0)
                - math.log(float(costs.shape[0])))
