"""MPF — Stein particle filter over dynamics parameters (counterpart of
`dust_tpu/inference/mpf.py`: `MPF`, `FusedPendulumMPF` and
`FusedParticleMPF`).

SVGD over parameter particles [n, dim], conditioned online on each new
observation. The score is the gradient of (GMM prior around the particles)
+ (Gaussian observation likelihood through a one-step model prediction);
`torch.func.grad` takes the place of `jax.grad`. The optimizer is plain
SGD, `x + lr * phi`.

Under `reference_compat=True` the kernel-gradient term is the attraction
through the first kernel argument, not divided by n (the reference's
sign); the default is the standard repulsion.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..distributions import GMM
from ..ops.bandwidth import bw_silverman, silvermans_rule
from ..ops.kernels import rbf_gram_and_grad
from ..ops.mpf import fused_pendulum_mpf_optimize
from ..ops.particle_mpf import fused_particle_mpf_optimize
from .likelihoods import GaussianLikelihood, LikelihoodState


@dataclass(frozen=True)
class MPFState:
    x: torch.Tensor          # [n, dim] parameter particles
    prior: GMM               # GMM centered on the particles
    lik: LikelihoodState
    # isotropic summary of the prior bandwidth (a vector bandwidth stores
    # its mean) — read by the fused kernel; the exact GMM stays in `prior`
    prior_bw: torch.Tensor


def _mean_bw(bw, device):
    return torch.as_tensor(bw, dtype=torch.float32, device=device).reshape(
        -1).mean()


class MPF:
    def __init__(self, likelihood: GaussianLikelihood, lr=1e-3,
                 optimizer="sgd", bw_scale=1.0, n_steps=100,
                 reference_compat=False):
        if optimizer != "sgd":
            raise ValueError(
                f"MPF supports plain SGD only, got optimizer={optimizer!r}"
            )
        self.likelihood = likelihood
        self.lr = float(lr)
        self.bw_scale = float(bw_scale)
        self.n_steps = int(n_steps)
        self.reference_compat = bool(reference_compat)

    def init_state(self, init_particles, initial_obs, dim_a, bw=None) -> MPFState:
        x = torch.as_tensor(init_particles, dtype=torch.float32)
        if x.ndim != 2:
            raise ValueError(
                "Particles must be two dimension with batch on dim 0."
            )
        if bw is None:
            # statsmodels-style Silverman at init (a per-dim vector when
            # the std wins)
            bw = bw_silverman(x, self.bw_scale)
        return MPFState(
            x=x,
            prior=self.make_prior(x, bw),
            lik=self.likelihood.init_state(
                torch.as_tensor(initial_obs, device=x.device), dim_a
            ),
            prior_bw=_mean_bw(bw, x.device),
        )

    def make_prior(self, x, bw):
        """Uniform-mixture GMM centered on the particles with isotropic (or
        per-dim, if bw is a vector) bw^2 covariance."""
        n, dim = x.shape
        bw_vec = torch.as_tensor(bw, dtype=torch.float32,
                                 device=x.device).reshape(-1)
        cov = torch.diag(bw_vec.expand(dim) ** 2)
        return GMM.from_cov(x, torch.ones(n, device=x.device), cov)

    def _grad_lik(self, mstate, x):
        """Gradient of the observation log-likelihood w.r.t. the
        particles."""
        def log_lik(t):
            pred = self.likelihood.sample(mstate.lik, t)
            return self.likelihood.log_prob(mstate.lik, pred).sum()

        return torch.func.grad(log_lik)(x)

    def phi(self, mstate: MPFState, bw):
        """Stein direction."""
        x = mstate.x
        score = self._grad_lik(mstate, x) + mstate.prior.score(x)
        k, grad_first = rbf_gram_and_grad(x, x, bw)
        if self.reference_compat:
            return grad_first + torch.tensordot(k, score, dims=1) / x.shape[0]
        return (torch.tensordot(k, score, dims=1) - grad_first) / x.shape[0]

    def step(self, mstate: MPFState, bw):
        phi = self.phi(mstate, bw)
        return (replace(mstate, x=mstate.x + self.lr * phi),
                torch.linalg.norm(phi))

    def _condition(self, mstate, action, new_obs):
        if new_obs is None:
            return mstate
        return replace(
            mstate, lik=self.likelihood.condition(mstate.lik, action, new_obs)
        )

    def _refresh_prior(self, mstate, x, bw):
        return replace(mstate, x=x, prior=self.make_prior(x, bw),
                       prior_bw=_mean_bw(bw, x.device))

    def optimize(self, mstate: MPFState, action, new_obs, bw=None,
                 n_steps=None):
        """Condition on the newest observation and run n_steps SVGD
        updates. Returns (new_mstate, grad_norms [n_steps], bw)."""
        mstate = self._condition(mstate, action, new_obs)
        if bw is None:
            bw = silvermans_rule(mstate.x) * self.bw_scale
        n = self.n_steps if n_steps is None else n_steps
        norms = []
        for _ in range(n):
            mstate, gnorm = self.step(mstate, bw)
            norms.append(gnorm)
        grads = (torch.stack(norms) if norms
                 else torch.zeros((0,), device=mstate.x.device))
        return self._refresh_prior(mstate, mstate.x, bw), grads, bw


class FusedPendulumMPF(MPF):
    """MPF whose whole optimize loop runs as ONE CUDA kernel with
    hand-derived pendulum-likelihood gradients (`ops/mpf.py`,
    `csrc/pendulum_mpf.cu`). Semantics = `MPF(reference_compat=False)`
    with a pendulum `GaussianLikelihood` over (length, mass) and the prior
    score taken with the isotropic `prior_bw`; `optimize` returns a zero
    grad-norm trace (the kernel does not surface per-step norms). On CPU
    tensors the kernel's plain PyTorch version runs instead."""

    def __init__(self, likelihood, lr=1e-3, bw_scale=1.0, n_steps=100):
        super().__init__(likelihood, lr=lr, bw_scale=bw_scale,
                         n_steps=n_steps, reference_compat=False)

    @classmethod
    def from_mpf(cls, mpf: MPF) -> "FusedPendulumMPF":
        """The fused counterpart of a plain `MPF` (same likelihood,
        learning rate, bandwidth scale and step count) — how the kernel
        path swaps K2 into a built stack."""
        if mpf.reference_compat:
            raise ValueError("FusedPendulumMPF has no reference_compat mode")
        return cls(mpf.likelihood, lr=mpf.lr, bw_scale=mpf.bw_scale,
                   n_steps=mpf.n_steps)

    def optimize(self, mstate: MPFState, action, new_obs, bw=None,
                 n_steps=None):
        mstate = self._condition(mstate, action, new_obs)
        if bw is None:
            bw = silvermans_rule(mstate.x) * self.bw_scale
        n = self.n_steps if n_steps is None else n_steps

        model = self.likelihood.model
        # the conditioned state's past_action (NOT the raw argument):
        # matches MPF semantics when re-optimizing with new_obs=None
        x = fused_pendulum_mpf_optimize(
            mstate.x, mstate.prior.locs, mstate.lik.past_obs,
            mstate.lik.loc, mstate.lik.past_action, bw, mstate.prior_bw,
            self.lr, self.likelihood.sigma, n_steps=n,
            dt=model.dt, g=model.params_dict["g"],
            log_space=self.likelihood.log_space,
        )
        return (self._refresh_prior(mstate, x, bw),
                torch.zeros((n,), device=x.device), bw)


class FusedParticleMPF(MPF):
    """MPF whose whole optimize loop runs as ONE CUDA kernel with the
    hand-derived mass-likelihood gradient of the particle task
    (`ops/particle_mpf.py`, `csrc/particle_mpf.cu`). Semantics =
    `MPF(reference_compat=False)` with a `GaussianLikelihood` over an
    acceleration-control `Particle` model and one uncertain mass
    parameter; `optimize` returns a zero grad-norm trace. The crash factor
    at the prediction start is evaluated once outside the kernel: every
    particle's prediction starts from the same past_obs. On CPU tensors
    the kernel's plain PyTorch version runs instead."""

    def __init__(self, likelihood, lr=1e-2, bw_scale=1.0, n_steps=100):
        model = likelihood.model
        if model.control_type != "acceleration":
            raise ValueError(
                "FusedParticleMPF requires acceleration control (the mass "
                "does not enter velocity-control dynamics)."
            )
        if tuple(model.uncertain_params) != ("mass",):
            raise ValueError(
                "FusedParticleMPF supports exactly one uncertain param: "
                f"('mass',), got {tuple(model.uncertain_params)}"
            )
        super().__init__(likelihood, lr=lr, bw_scale=bw_scale,
                         n_steps=n_steps, reference_compat=False)

    @classmethod
    def from_mpf(cls, mpf: MPF) -> "FusedParticleMPF":
        """The fused counterpart of a plain `MPF` (same likelihood,
        learning rate, bandwidth scale and step count) — how the kernel
        path swaps K7 into a built stack."""
        if mpf.reference_compat:
            raise ValueError("FusedParticleMPF has no reference_compat mode")
        return cls(mpf.likelihood, lr=mpf.lr, bw_scale=mpf.bw_scale,
                   n_steps=mpf.n_steps)

    def optimize(self, mstate: MPFState, action, new_obs, bw=None,
                 n_steps=None):
        mstate = self._condition(mstate, action, new_obs)
        if bw is None:
            bw = silvermans_rule(mstate.x) * self.bw_scale
        n = self.n_steps if n_steps is None else n_steps

        model = self.likelihood.model
        if model.can_crash and model.with_obstacle:
            collision = model.obst_map.get_collisions(mstate.lik.past_obs[0:2])
        else:
            collision = torch.zeros((), device=mstate.x.device)
        scale = model.dt * (1.0 - collision)
        # the conditioned state's past_action (NOT the raw argument):
        # matches MPF semantics when re-optimizing with new_obs=None
        x = fused_particle_mpf_optimize(
            mstate.x, mstate.prior.locs, mstate.lik.past_obs,
            mstate.lik.loc, mstate.lik.past_action, scale, bw,
            mstate.prior_bw, self.lr, self.likelihood.sigma, n_steps=n,
            max_acc=model.max_acc, max_speed=model.max_speed,
            log_space=self.likelihood.log_space,
        )
        return (self._refresh_prior(mstate, x, bw),
                torch.zeros((n,), device=x.device), bw)
