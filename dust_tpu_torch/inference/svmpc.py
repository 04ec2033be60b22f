"""SVMPC — Stein variational MPC over control-sequence particles
(counterpart of `dust_tpu/inference/svmpc.py`: `SVMPC` and the
whole-solve classes `FusedPendulumSVMPC` (K3) and `FusedParticleSVMPC`
(K8)).

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


@dataclass(frozen=True)
class FusedSVMPCState:
    """`SVMPCState` plus the forward-pass outputs the fused solve kernel
    computes up front (K3 runs optimize AND forward in one launch;
    `forward` then commits the cached results)."""

    theta: torch.Tensor        # [m, H, A]
    prior: GMM
    fwd_theta: torch.Tensor    # [m, H, A] (rolled)
    fwd_a_seq: torch.Tensor    # [H, A]
    fwd_weights: torch.Tensor  # [m]


class _FusedSolveSVMPC(SVMPC):
    """Base for SVMPC variants whose whole solve (sample -> rollout ->
    cost -> DISCO update -> Stein step -> selection -> roll) runs as one
    kernel launch.

    Supported semantics (asserted): kernel="rbf", reference_compat=False,
    n_steps=1, roll_strategy="repeat", SGD, isotropic action covariance
    and policy prior, controller a_reg == 0 (the demo temperature and
    ctrl_penalty make the control penalty vanish), params mode
    none|sampled, ExpectedCost|ExponentiatedUtility. `optimize` draws from
    the generator in the plain path's order and shapes (action noise, then
    the dynamics-parameter draws), so fused and plain agree on one seed."""

    def __init__(self, likelihood, **kwargs):
        kwargs.setdefault("kernel", "rbf")
        super().__init__(likelihood, **kwargs)
        from .likelihoods import ExpectedCost, ExponentiatedUtility

        ctrl = self.controller
        if self.kernel != "rbf" or self.reference_compat:
            raise ValueError("fused solve: kernel='rbf', no compat mode")
        if self.n_steps != 1:
            raise ValueError("fused solve supports n_steps=1")
        if self.roll_strategy != "repeat":
            raise ValueError("fused solve: roll_strategy='repeat'")
        if abs(ctrl.a_reg) > 1e-12:
            raise ValueError(
                "fused solve requires a_reg == 0 (temperature *"
                " (1 - ctrl_penalty)); use the plain SVMPC otherwise"
            )
        if ctrl._params_mode not in ("none", "sampled"):
            raise ValueError("fused solve: params mode none|sampled")
        if not isinstance(likelihood, (ExpectedCost, ExponentiatedUtility)):
            raise ValueError("fused solve: ExpectedCost|ExponentiatedUtility")
        sig = self.sigma.detach().cpu()
        if not torch.allclose(sig, sig[0].expand_as(sig)):
            raise ValueError("fused solve: isotropic action covariance")
        self._exp_util = isinstance(likelihood, ExponentiatedUtility)
        self._model = likelihood.model
        self._check_model(self._model)

    def _check_model(self, model):
        raise NotImplementedError

    def _run_kernel(self, state, theta, locs, log_mix, a_mat, a_seq,
                    actions, cols, bw, prior_scale, hz, m):
        raise NotImplementedError

    def init_state(self, init_particles, prior: GMM) -> FusedSVMPCState:
        theta = torch.as_tensor(init_particles, dtype=torch.float32)
        ps = prior.scale_tril.detach().cpu()
        a = self.ctrl_dim
        if tuple(ps.shape) != (a, a) or not torch.allclose(
                ps, ps[0, 0] * torch.eye(a)):
            raise ValueError("fused solve: isotropic policy prior")
        return FusedSVMPCState(
            theta=theta, prior=prior, fwd_theta=theta, fwd_a_seq=theta[0],
            fwd_weights=torch.full((theta.shape[0],), float("nan"),
                                   device=theta.device),
        )

    def optimize(self, svstate, dstate, state, params_dist, generator,
                 bw=None, n_steps=None, noise=None):
        """One whole solve. `noise` optionally injects the standard-normal
        action draw [n_samples, m, H, A], as `SVMPC.svgd_step` takes it."""
        if n_steps not in (None, 1):
            raise ValueError("fused solve supports n_steps=1")
        theta = svstate.theta                       # [m, H, A]
        m, hz, a = theta.shape
        ctrl = self.controller
        if bw is None:
            bw = silvermans_rule(theta)
        # the plain path's draws, in its order: CostLikelihood.sample's
        # action noise, then MultiDisco._sample_params' parameter draws
        if noise is None:
            noise = torch.randn((self.likelihood.n_samples, m, hz, a),
                                generator=generator, device=theta.device)
        actions = theta + noise @ ctrl.a_scale_tril.T
        cols = {}
        if ctrl._params_mode == "sampled":
            draws = params_dist.sample(generator, (ctrl.n_params,))
            if ctrl._params_log_space:
                draws = torch.exp(draws)
            draws = draws.reshape(ctrl.n_params, -1)
            cols = {k: draws[:, i]
                    for i, k in enumerate(self._model.uncertain_params)}

        log_mix = torch.log_softmax(svstate.prior.logits, dim=0)
        (theta_opt, theta_fwd, a_mat, a_mix, a_seq_sel, weights,
         costs) = self._run_kernel(
            state, theta, svstate.prior.locs, log_mix, dstate.a_mat,
            dstate.a_seq, actions, cols, bw, svstate.prior.scale_tril[0, 0],
            hz, m,
        )
        svstate = replace(svstate, theta=theta_opt, fwd_theta=theta_fwd,
                          fwd_a_seq=a_seq_sel, fwd_weights=weights)
        dstate = replace(dstate, a_mat=a_mat, a_mix=a_mix)
        return svstate, dstate, costs

    def forward(self, svstate, costs, generator=None, steps=-1):
        """Commit the kernel's selection and roll and refresh the prior
        (weighted by the posterior weights when `weighted_prior`).
        `costs`/`generator` are accepted for interface parity; the roll is
        always the "repeat" strategy at steps=-1."""
        if steps != -1:
            raise ValueError("fused solve supports steps=-1")
        theta = svstate.fwd_theta
        if self.weighted_prior:
            logits = torch.log(torch.clamp(svstate.fwd_weights, min=1e-37))
        else:
            logits = torch.zeros(theta.shape[0], device=theta.device)
        prior = GMM(locs=theta, scale_tril=svstate.prior.scale_tril,
                    logits=logits)
        svstate = replace(svstate, theta=theta, prior=prior)
        return svstate, svstate.fwd_a_seq, svstate.fwd_weights


class FusedPendulumSVMPC(_FusedSolveSVMPC):
    """Whole-solve-fused SVMPC for the pendulum task (ctrl_dim 1,
    unweighted prior, length/mass parameter columns): K3,
    `ops/solve.py:fused_pendulum_solve`."""

    def _check_model(self, model):
        from ..models.pendulum import PendulumModel

        if self.ctrl_dim != 1:
            raise ValueError("pendulum fused solve supports ctrl_dim=1")
        if self.weighted_prior:
            raise ValueError("pendulum fused solve: unweighted prior")
        if not isinstance(model, PendulumModel):
            raise ValueError("fused solve is model-specific (pendulum)")
        if not set(model.uncertain_params or ()) <= {"length", "mass"}:
            raise ValueError("fused solve: length/mass parameters only")

    def _run_kernel(self, state, theta, locs, log_mix, a_mat, a_seq,
                    actions, cols, bw, prior_scale, hz, m):
        from ..ops.solve import fused_pendulum_solve

        ctrl = self.controller
        defaults = self._model.params_dict
        dev = theta.device
        default = lambda k: torch.full((ctrl.n_params,), float(defaults[k]),
                                       device=dev)
        lengths = cols.get("length", default("length"))
        masses = cols.get("mass", default("mass"))
        (theta_opt, theta_fwd, amat, a_mix, a_seq_sel, weights,
         costs) = fused_pendulum_solve(
            state.reshape(-1)[:2], theta[..., 0], locs[..., 0], log_mix,
            a_mat[..., 0], a_seq[..., 0], actions[..., 0], lengths, masses,
            bw, self.lr, self.likelihood.alpha, ctrl.temp, self.sigma[0],
            prior_scale, hz=hz, m=m, n_params=ctrl.n_params,
            n_act=self.likelihood.n_samples, dt=float(self._model.dt),
            g=float(defaults["g"]), exp_util=self._exp_util,
        )
        return (theta_opt[..., None], theta_fwd[..., None],
                amat[..., None], a_mix, a_seq_sel[:, None], weights, costs)


class FusedParticleSVMPC(_FusedSolveSVMPC):
    """Whole-solve-fused SVMPC for the particle-navigation task (ctrl_dim
    2, optionally weighted prior, a mass parameter column, rectangle
    collisions in the kernel): K8, `ops/solve.py:fused_particle_solve`."""

    def _check_model(self, model):
        from ..ops.particle_rollout import particle_kernel_statics

        if self.ctrl_dim != 2:
            raise ValueError("particle fused solve supports ctrl_dim=2")
        # validates control type, determinism and uncertain params, and
        # extracts the cost/collision configuration
        self._statics = particle_kernel_statics(model)

    def _run_kernel(self, state, theta, locs, log_mix, a_mat, a_seq,
                    actions, cols, bw, prior_scale, hz, m):
        from ..ops.solve import fused_particle_solve

        ctrl = self.controller
        model = self._model
        masses = cols.get(
            "mass",
            torch.full((ctrl.n_params,), float(model.params_dict["mass"]),
                       device=theta.device),
        )
        return fused_particle_solve(
            state.reshape(-1)[:4], theta, locs, log_mix, a_mat, a_seq,
            actions, masses, bw, self.lr, self.likelihood.alpha, ctrl.temp,
            self.sigma[0], prior_scale, hz=hz, m=m, n_params=ctrl.n_params,
            n_act=self.likelihood.n_samples, dt=float(model.dt),
            max_acc=float(model.max_acc), max_speed=float(model.max_speed),
            exp_util=self._exp_util, **self._statics,
        )
