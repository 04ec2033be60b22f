"""MPF — Stein particle filter over dynamics parameters (counterpart of
`dust_tpu/inference/mpf.py`: `MPF`, `ClosedFormPendulumMPF`,
`FusedPendulumMPF`, `FusedParticleMPF` and `FusedMPF`).

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

import math
from dataclasses import dataclass, replace

import torch

from ..distributions import GMM
from ..ops.bandwidth import bw_silverman, silvermans_rule
from ..ops.gmm import (
    gmm_prior_score_streamed,
    gmm_prior_score_streamed_packed,
)
from ..ops.kernels import rbf_gram_and_grad
from ..ops.mpf import fused_pendulum_mpf_optimize
from ..ops.mpf_stream import fused_mpf_stream_step
from ..ops.particle_mpf import fused_particle_mpf_optimize
from ..ops.svgd import svgd_phi_streamed, svgd_phi_streamed_packed
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


class ClosedFormPendulumMPF(MPF):
    """MPF with the Gaussian-likelihood gradient through the pendulum
    transition written in closed form (K2's derivation, `ops/mpf.py`):
    the speed clip gates the gradient, and under `log_space` the chain
    rule multiplies by the parameters. Semantics =
    `MPF(reference_compat=False)` with a pendulum `GaussianLikelihood`
    over (length, mass); `reference_compat` is forced off."""

    def __init__(self, likelihood, **kwargs):
        kwargs.pop("reference_compat", None)
        super().__init__(likelihood, reference_compat=False, **kwargs)

    def _grad_lik(self, mstate, x):
        lik = self.likelihood
        model = lik.model
        dt = model.dt
        g = model.params_dict["g"]
        sigma = lik.sigma
        theta0, theta_d0 = mstate.lik.past_obs[0], mstate.lik.past_obs[1]
        loc0, loc1 = mstate.lik.loc[0], mstate.lik.loc[1]
        acts = torch.clamp(mstate.lik.past_action.reshape(-1)[0], -2.0, 2.0)
        sin_t = torch.sin(theta0 + math.pi)

        length = x[:, 0:1]
        mass = x[:, 1:2]
        if lik.log_space:
            length = torch.exp(length)
            mass = torch.exp(mass)
        il = 1.0 / length
        im = 1.0 / mass
        tdd = -1.5 * g * il * sin_t + 3.0 * im * il * il * acts
        theta_d_raw = theta_d0 + dt * tdd
        theta_d = torch.clamp(theta_d_raw, -8.0, 8.0)
        theta = theta0 + theta_d * dt
        gate = ((theta_d_raw > -8.0) & (theta_d_raw < 8.0)).to(x.dtype)
        dtd_dl = gate * dt * (1.5 * g * il * il * sin_t
                              - 6.0 * im * il**3 * acts)
        dtd_dm = gate * dt * (-3.0 * im * im * il * il * acts)
        common = -((theta - loc0) * dt + (theta_d - loc1)) / sigma**2
        gl_l = common * dtd_dl
        gl_m = common * dtd_dm
        if lik.log_space:
            gl_l = gl_l * length
            gl_m = gl_m * mass
        return torch.cat([gl_l, gl_m], dim=1)


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


class FusedMPF(MPF):
    """MPF whose two O(m^2) objects, the RBF Stein direction and the GMM
    prior score, run as streamed kernels that never store an [m, m]
    matrix (K11 `ops/svgd.py`, K12 `ops/gmm.py`): for large particle
    counts. Semantics = `MPF(reference_compat=False)` with the prior score
    taken at the isotropic `prior_bw`.

    `packed="auto"` takes the packed entries (K11b, K12b) for m >= 4096
    and d <= 8, the gram entries (K11a, K12a) otherwise (True/False force
    them, d > 8 always takes the gram entries); on the card both launch
    the same kernels. `use_bf16` rounds the packed entries' products to
    bf16. `fuse_streams=True` runs each SVGD iteration as one launch (K13,
    `ops/mpf_stream.py`) that also returns the next iteration's prior
    score; it applies the SGD step inside the kernel, so it needs
    `fused_lr`, and an `lr` other than `fused_lr` raises; it ignores
    `use_bf16`, as JAX's does. The `optimize` of `fuse_streams` returns
    the norms of (x_new - x) / lr, as JAX's does."""

    def __init__(self, likelihood, packed="auto", use_bf16=False,
                 fuse_streams=False, fused_lr=None, **kwargs):
        if kwargs.pop("reference_compat", False):
            raise ValueError("FusedMPF has no reference_compat mode")
        self._fuse_streams = bool(fuse_streams)
        if self._fuse_streams:
            if fused_lr is None:
                raise ValueError(
                    "FusedMPF(fuse_streams=True) applies the SGD update "
                    "inside the fused kernel; pass fused_lr=<sgd lr>")
            if "lr" in kwargs and float(kwargs["lr"]) != float(fused_lr):
                raise ValueError(
                    f"FusedMPF(fuse_streams=True) steps at fused_lr="
                    f"{fused_lr}; lr={kwargs['lr']} would not be applied")
            kwargs["lr"] = fused_lr
        super().__init__(likelihood, reference_compat=False, **kwargs)
        if packed != "auto" and not isinstance(packed, bool):
            raise ValueError("packed must be 'auto', True or False")
        self._packed = packed
        self._use_bf16 = bool(use_bf16)

    @staticmethod
    def _blk_j(m):
        """The TPU stream-block size JAX picks for m (its tile sizes; no
        effect on the card)."""
        return min(8192, max(1024, -(-m // 1024) * 1024))

    def _use_packed(self, m, d):
        if d > 8:
            return False
        if self._packed == "auto":
            return m >= 4096
        return self._packed

    def phi(self, mstate: MPFState, bw):
        x = mstate.x
        m = x.shape[0]
        blk_j = self._blk_j(m)
        if self._use_packed(m, x.shape[1]):
            gp = gmm_prior_score_streamed_packed(
                x, mstate.prior.locs, mstate.prior_bw, block_k=blk_j,
                use_bf16=self._use_bf16)
            score = self._grad_lik(mstate, x) + gp
            return svgd_phi_streamed_packed(x, score, bw, block_j=blk_j,
                                            use_bf16=self._use_bf16)
        gp = gmm_prior_score_streamed(x, mstate.prior.locs, mstate.prior_bw)
        score = self._grad_lik(mstate, x) + gp
        return svgd_phi_streamed(x, score, bw)

    def optimize(self, mstate: MPFState, action, new_obs, bw=None,
                 n_steps=None):
        if not self._fuse_streams:
            return super().optimize(mstate, action, new_obs, bw=bw,
                                    n_steps=n_steps)
        mstate = self._condition(mstate, action, new_obs)
        if bw is None:
            bw = silvermans_rule(mstate.x) * self.bw_scale
        n = self.n_steps if n_steps is None else n_steps
        x = mstate.x
        m, d = x.shape
        if d > 8:
            raise ValueError("fuse_streams requires d <= 8 (the packed "
                             "operand lane layout)")
        centers, pbw, lr = mstate.prior.locs, mstate.prior_bw, self.lr
        blk_j = self._blk_j(m)
        # iteration 0's prior score comes from the standalone kernel;
        # every later one from the previous fused step
        gp = gmm_prior_score_streamed_packed(x, centers, pbw, block_k=blk_j)
        norms = []
        for _ in range(n):
            score = self._grad_lik(mstate, x) + gp
            x_new, gp = fused_mpf_stream_step(x, score, centers, bw, pbw, lr,
                                              block_j=blk_j)
            norms.append(torch.linalg.norm((x_new - x) * (1.0 / lr)))
            x = x_new
        grads = (torch.stack(norms) if norms
                 else torch.zeros((0,), device=x.device))
        return self._refresh_prior(mstate, x, bw), grads, bw
