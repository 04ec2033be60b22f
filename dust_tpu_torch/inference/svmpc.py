"""SVMPC — Stein variational MPC over control-sequence particles
(counterpart of `dust_tpu/inference/svmpc.py`, plain `SVMPC` only).

Policy particles theta [m, horizon, ctrl_dim] follow the Stein direction
of the control posterior: a GMM prior around the previous particles plus
a cost pseudo-likelihood evaluated by the DISCO controller's batched
rollouts. The optimizer is plain SGD, `theta + lr * phi`.

Kernel paths:

* "rbf" — flat-particle RBF. Under `reference_compat=True` two reference
  quirks are reproduced: the lengthscale stays at softplus(0) = ln 2
  (PARITY #1), and the kernel-gradient term is the attraction through the
  first argument, not divided by m (PARITY #2).
* "message_passing" — the `iid_mp` per-timestep kernel with analytic
  gradients.

`reference_compat` also reproduces the live-prior aliasing of
`get_weights` (PARITY #19).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

from ..distributions import GMM
from ..ops.bandwidth import silvermans_rule
from ..ops.kernels import iid_mp, rbf_gram_and_grad

# gpytorch RBFKernel default lengthscale: softplus(raw=0) = ln 2
_GPYTORCH_DEFAULT_LENGTHSCALE = math.log(2.0)


@dataclass(frozen=True)
class SVMPCState:
    theta: torch.Tensor   # [m, H, A]
    prior: GMM            # over event [H, A]
    # True once update_prior has run — drives the reference_compat
    # live-prior quirk in get_weights (PARITY #19)
    prior_updated: bool = False


class SVMPC:
    def __init__(
        self,
        likelihood,
        kernel="rbf",
        ctrl_dim=None,
        indep_controls=True,
        n_particles=None,
        n_steps=1,
        lr=0.1,
        optimizer="sgd",
        bw_scale=1.0,
        roll_strategy="repeat",
        weighted_prior=False,
        reference_compat=False,
    ):
        if optimizer != "sgd":
            raise ValueError(
                f"SVMPC supports plain SGD only, got optimizer={optimizer!r}"
            )
        self.likelihood = likelihood
        self.controller = likelihood.controller
        self.kernel = kernel
        self.ctrl_dim = ctrl_dim if ctrl_dim is not None else self.controller.dim_a
        self.indep_controls = bool(indep_controls)
        self.n_particles = int(n_particles)
        self.n_steps = int(n_steps)
        self.lr = float(lr)
        self.bw_scale = float(bw_scale)
        self.roll_strategy = roll_strategy
        self.weighted_prior = bool(weighted_prior)
        self.reference_compat = bool(reference_compat)
        # sigma for the analytic likelihood gradient
        self.sigma = torch.sqrt(torch.diagonal(self.controller.a_cov))

    def init_state(self, init_particles, prior: GMM) -> SVMPCState:
        theta = torch.as_tensor(init_particles, dtype=torch.float32)
        return SVMPCState(theta=theta, prior=prior, prior_updated=False)

    # -- Stein direction --------------------------------------------------

    def phi(self, svstate: SVMPCState, dstate, state, params_dist, generator,
            bw, noise=None):
        """Returns (phi [m, H, A], new_dstate, costs [n_samples, m])."""
        x = svstate.theta
        m = x.shape[0]

        grad_pri = svstate.prior.score(x)

        new_dstate, costs, actions, _, _ = self.likelihood.sample(
            dstate, x, state, params_dist, generator, noise=noise
        )
        # analytic likelihood gradient: per-particle softmax cost weights
        # over action samples x reparameterized score
        alpha = self.likelihood.alpha
        w = torch.softmax(-costs * alpha, dim=0)            # [n_samples, m]
        d_log_pi = (actions - x) / self.sigma**2            # [n_s, m, H, A]
        grad_lik = (w[..., None, None] * d_log_pi).sum(dim=0)
        score = grad_lik + grad_pri                         # [m, H, A]

        flat = x.reshape(m, -1)
        if self.kernel == "message_passing":
            k, dk = iid_mp(flat, flat, self.ctrl_dim, self.indep_controls)
            grad = (k * score.reshape(1, m, -1)).mean(dim=1)
            rep = dk.mean(dim=1)
            phi = (grad + rep).reshape(x.shape)
        elif self.kernel == "rbf":
            bw_eff = (
                torch.tensor(_GPYTORCH_DEFAULT_LENGTHSCALE, device=x.device)
                if self.reference_compat
                else bw
            )
            k, grad_first = rbf_gram_and_grad(flat, flat, bw_eff)
            if self.reference_compat:
                phi = (grad_first.reshape(x.shape)
                       + torch.tensordot(k, score, dims=1) / m)
            else:
                phi = (torch.tensordot(k, score, dims=1)
                       - grad_first.reshape(x.shape)) / m
        else:
            raise ValueError(f"Kernel type '{self.kernel}' is not valid.")
        return phi, new_dstate, costs

    def svgd_step(self, svstate, dstate, state, params_dist, generator, bw,
                  noise=None):
        phi, new_dstate, costs = self.phi(
            svstate, dstate, state, params_dist, generator, bw, noise=noise
        )
        theta = svstate.theta + self.lr * phi
        return replace(svstate, theta=theta), new_dstate, costs

    def optimize(self, svstate, dstate, state, params_dist, generator,
                 bw=None, n_steps=None):
        """n_steps SVGD updates. Returns (svstate, dstate, costs) with the
        last step's costs."""
        if bw is None:
            bw = silvermans_rule(svstate.theta)
        n = self.n_steps if n_steps is None else n_steps
        costs = None
        for _ in range(n):
            svstate, dstate, costs = self.svgd_step(
                svstate, dstate, state, params_dist, generator, bw
            )
        return svstate, dstate, costs

    # -- weights / selection / roll / prior -------------------------------

    def get_weights(self, svstate, costs):
        log_l = self.likelihood.log_prob(costs)             # [m]
        log_p = svstate.prior.log_prob(svstate.theta)       # [m]
        if self.reference_compat and svstate.prior_updated:
            # PARITY #19: after the first prior refresh the reference's
            # prior locs alias the particles that optimize() mutates, so
            # the prior is centered on the CURRENT particles
            live = GMM(locs=svstate.theta,
                       scale_tril=svstate.prior.scale_tril,
                       logits=svstate.prior.logits)
            log_p = live.log_prob(svstate.theta)
        log_w = log_l + log_p
        return torch.exp(log_w - torch.logsumexp(log_w, dim=0))

    def roll(self, svstate, generator=None, steps=-1):
        """Shift particles along the horizon and fill the last step."""
        theta = torch.roll(svstate.theta, steps, dims=-2)
        if self.roll_strategy == "repeat":
            theta[..., -1, :] = theta[..., -2, :]
        elif self.roll_strategy == "resample":
            draw = svstate.prior.sample(generator, (self.n_particles,))
            theta[..., -1, :] = draw[..., -1, :]
        elif self.roll_strategy == "mean":
            theta[..., -1, :] = theta.mean(dim=-2)
        else:
            raise ValueError(
                f"{self.roll_strategy} is an invalid roll strategy."
            )
        return replace(svstate, theta=theta)

    def update_prior(self, svstate, weights=None):
        """Rebuild the GMM prior around the current particles with the
        previous component covariance."""
        if weights is None or not self.weighted_prior:
            logits = torch.zeros(svstate.theta.shape[0],
                                 device=svstate.theta.device)
        else:
            logits = torch.log(torch.clamp(weights, min=1e-37))
        prior = GMM(locs=svstate.theta, scale_tril=svstate.prior.scale_tril,
                    logits=logits)
        return replace(svstate, prior=prior, prior_updated=True)

    def forward(self, svstate, costs, generator=None, steps=-1):
        """Select the best particle, roll, refresh the prior. Returns
        (svstate, a_seq [H, A], weights [m])."""
        weights = self.get_weights(svstate, costs)
        a_seq = svstate.theta[torch.argmax(weights)]
        svstate = self.roll(svstate, generator=generator, steps=steps)
        svstate = self.update_prior(svstate, weights)
        return svstate, a_seq, weights
