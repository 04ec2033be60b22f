"""Policy-particle sharded SVMPC (counterpart of
`dust_tpu/parallel/svmpc_sharded.py`).

In SVMPC the compute scales as n_params x action_samples x n_particles
rollouts per SVGD step: for large particle counts this is the axis to
shard. Each rank owns m/p policy particles and their rows of the
controller plan (`a_mat` rows are per policy), rolls out only its own
action samples, and the few cross-particle quantities reassemble with
collectives:

* the global cost minimum `beta`: a MIN (the reference's order kept);
* the policy-mixture normalizer `a_mix = softmax(eta)` over all
  policies: a MAX / SUM logsumexp;
* the RBF kernel term: the gathered particles and scores, the rank's row
  block of the Gram.

Semantics = `SVMPC(kernel="rbf", reference_compat=False)` with the
SVMPC's optimizer: each rank updates its rows of the optimizer state's
per-particle leaves (Adam's moments, `optim.is_per_particle`) and keeps
the others (Adam's count) whole, the same on every rank. The
message-passing kernel is not supported: its per-slice median bandwidth
needs the full pairwise matrix per slice. Nor is a UTF controller: the
sigma-weighted cost path is not sharded.

Randomness: JAX folds the device index into the key. Here the parameter
draws come from the caller's generator, the same on every rank, and each
rank's action noise from a generator seeded from (a seed drawn from the
caller's generator, the rank's index): equal to JAX's in distribution
only. `noise=` injects the standard-normal draw instead.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..controllers.disco import DiscoState
from ..inference.optim import is_per_particle, opt_update
from ..utils.helper import _map_tree
from .mesh import all_gather_rows, all_reduce, axis_index, block
from .rollout import rollout_costs

_SEED_MOD = 2**62


class ShardedSVMPC:
    """Wraps an `SVMPC` (rbf kernel, standard-SVGD mode) with a
    particle-sharded SVGD step. `svstate.theta` [m, H, A], `dstate.a_mat`
    [m, H, A] and `dstate.a_mix` [m] are split on the particle axis
    (n_policies == n_particles, as in every SVMPC configuration); the
    prior stays whole (its centers are all particles). The states stay
    whole on every rank (global in, global out)."""

    def __init__(self, svmpc, model, mesh, axis="particle"):
        from ..inference.svmpc import _FusedSolveSVMPC

        if isinstance(svmpc, _FusedSolveSVMPC):
            raise TypeError("ShardedSVMPC wraps the plain SVMPC, not a "
                            "whole-solve kernel class")
        if svmpc.kernel != "rbf" or svmpc.reference_compat:
            raise ValueError("ShardedSVMPC supports kernel='rbf' with "
                             "reference_compat=False")
        if svmpc.controller._params_mode == "utf":
            raise ValueError(
                "ShardedSVMPC does not support UTF sigma-point controllers"
                " (the sigma-weighted cost path is not sharded); use"
                " 'sampled' or 'none' parameter modes")
        self.svmpc = svmpc
        self.controller = svmpc.controller
        self.model = model
        self.mesh = mesh
        self.axis = axis

    def shard_states(self, svstate, dstate):
        """Check that the particle axis splits over the mesh (theta,
        a_mat, a_mix and the optimizer state's per-particle leaves share
        it) and that every other optimizer-state leaf is a scalar, which
        each rank updates alike. The port keeps the states whole on every
        rank and shards the work, so they are returned as they are."""
        m = svstate.theta.shape[0]
        if dstate.a_mat.shape[0] != m or dstate.a_mix.shape[0] != m:
            raise ValueError("ShardedSVMPC needs n_policies == n_particles")
        block(m, self.mesh, self.axis)

        def check(leaf):
            if isinstance(leaf, torch.Tensor) and leaf.ndim > 0 \
                    and not is_per_particle(leaf, m):
                raise ValueError(
                    f"ShardedSVMPC: an optimizer-state leaf of shape "
                    f"{tuple(leaf.shape)} is neither per particle ({m} "
                    f"rows) nor a scalar")
            return leaf

        _map_tree(check, svstate.opt_state)
        return svstate, dstate

    def _params(self, params_dist, generator):
        """The dynamics-parameter draws, the same on every rank (the
        caller's generator is)."""
        ctrl = self.controller
        if ctrl._params_mode == "sampled":
            params, _ = ctrl._sample_params(generator, self.model,
                                            params_dist)
            return params
        return None

    def local_step(self, theta, opt_state, a_seq, a_mat, a_mix, prior,
                   state, params, bw, noise, lr=None, generator=None,
                   flat_all=None):
        """The rank's body on its own particle rows: theta [ml, H, A], the
        optimizer state's rows (its per-particle leaves cut to the rank's
        rows), a_mat [ml, H, A], a_mix [ml], noise [n_samples, ml, H, A]
        (the standard-normal draw), the whole prior and the shared
        parameter draws; `lr` a state's own rate or None. Returns (theta,
        opt_state, a_mat, a_mix, costs [n_samples, ml]) of the rank's
        rows. `flat_all` (the whole flattened particles) saves their
        gather where the caller holds them."""
        svmpc, ctrl, mesh, axis = (self.svmpc, self.controller, self.mesh,
                                   self.axis)
        ml = theta.shape[0]
        actions = theta + noise @ ctrl.a_scale_tril.T   # [n_s, ml, H, A]
        eps = actions - a_seq
        local = DiscoState(a_seq=a_seq, a_mat=a_mat, a_mix=a_mix)
        costs = rollout_costs(ctrl, self.model, local, state, actions,
                              params, generator)

        # the information-theoretic plan update with collectives
        beta = all_reduce(costs.min(), "min", mesh, axis)
        log_costs = -(costs - beta) / ctrl.temp
        eta = torch.logsumexp(log_costs, dim=0)          # [ml] per policy
        omega = torch.exp(log_costs - eta)
        a_mat = a_mat + torch.einsum("ip,ipta->pta", omega, eps)
        eta_max = all_reduce(eta.max(), "max", mesh, axis)
        lse = eta_max + torch.log(
            all_reduce(torch.exp(eta - eta_max).sum(), "sum", mesh, axis))
        a_mix = torch.exp(eta - lse)

        # the Stein direction (standard SVGD, rbf)
        grad_pri = prior.score(theta)
        w = torch.softmax(-costs * svmpc.likelihood.alpha, dim=0)
        d_log_pi = (actions - theta) / svmpc.sigma**2
        grad_lik = (w[..., None, None] * d_log_pi).sum(dim=0)
        score = grad_lik + grad_pri

        flat_l = theta.reshape(ml, -1)
        if flat_all is None:
            flat_all = all_gather_rows(flat_l, mesh, axis)
        score_all = all_gather_rows(score.reshape(ml, -1), mesh, axis)
        m_total = flat_all.shape[0]
        # center by the global mean before the Gram identity (the
        # cancellation error grows with ||theta||^2; K, the repulsion and
        # phi are translation invariant)
        mu = flat_all.mean(dim=0, keepdim=True).detach()
        flat_l = flat_l - mu
        flat_all = flat_all - mu
        d2 = ((flat_l**2).sum(dim=1, keepdim=True)
              + (flat_all**2).sum(dim=1)[None, :]
              - 2.0 * flat_l @ flat_all.T)
        kmat = torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * bw**2))
        drive = kmat @ score_all
        repel = (kmat.sum(dim=1, keepdim=True) * flat_l
                 - kmat @ flat_all) / bw**2
        phi = ((drive + repel) / m_total).reshape(theta.shape)
        updates, opt_state = opt_update(svmpc.optimizer, -phi, opt_state,
                                        theta, lr)
        return theta + updates, opt_state, a_mat, a_mix, costs

    def svgd_step(self, svstate, dstate, state, params_dist, generator, bw,
                  noise=None):
        """One particle-sharded SVGD update; the returns of
        `SVMPC.svgd_step`, whole on every rank. `noise` [n_samples, m, H,
        A] injects the standard-normal action draw (the same on every
        rank)."""
        theta = svstate.theta
        m, hz, a = theta.shape
        mesh, axis = self.mesh, self.axis
        rows = block(m, mesh, axis)
        dev = theta.device
        bw = torch.as_tensor(bw, dtype=torch.float32, device=dev)
        gen_rank = None
        if noise is None:
            # a seed from the caller's generator (the same on every rank),
            # then the rank's own stream
            seed = int(torch.randint(0, _SEED_MOD, (1,), generator=generator,
                                     device=generator.device))
            gen_rank = torch.Generator(device=dev).manual_seed(
                (seed * 1_000_003 + axis_index(mesh, axis)) % _SEED_MOD)
            noise_l = torch.randn(
                (self.svmpc.likelihood.n_samples, rows.stop - rows.start,
                 hz, a), generator=gen_rank, device=dev)
        else:
            noise_l = noise[:, rows]
        params = self._params(params_dist, generator)
        # which optimizer leaves are per particle, in the order _map_tree
        # walks them
        flags = []
        _map_tree(lambda leaf: flags.append(is_per_particle(leaf, m)),
                  svstate.opt_state)
        it = iter(flags)
        opt_local = _map_tree(lambda leaf: leaf[rows] if next(it) else leaf,
                              svstate.opt_state)
        th, opt_local, a_mat, a_mix, costs = self.local_step(
            theta[rows], opt_local, dstate.a_seq, dstate.a_mat[rows],
            dstate.a_mix[rows], svstate.prior, state, params, bw, noise_l,
            svstate.lr, generator=gen_rank, flat_all=theta.reshape(m, -1))
        ml = th.shape[0]
        opt_rows = []
        it = iter(flags)
        _map_tree(lambda leaf: opt_rows.append(leaf) if next(it) else None,
                  opt_local)
        # one gather of everything the rank's rows produced
        parts = [th, a_mat, a_mix[:, None], costs.T, *opt_rows]
        widths = [p[0].numel() for p in parts]
        packed = all_gather_rows(
            torch.cat([p.reshape(ml, -1) for p in parts], dim=1), mesh,
            axis)
        cols = packed.split(widths, dim=1)
        theta = cols[0].reshape(m, hz, a)
        a_mat = cols[1].reshape(m, hz, a)
        a_mix = cols[2][:, 0]
        costs = cols[3].T.contiguous()
        whole = iter(c.reshape(m, *p.shape[1:])
                     for c, p in zip(cols[4:], opt_rows))
        it = iter(flags)
        opt_state = _map_tree(lambda leaf: next(whole) if next(it) else leaf,
                              opt_local)
        return (replace(svstate, theta=theta, opt_state=opt_state),
                replace(dstate, a_mat=a_mat, a_mix=a_mix), costs)

    def forward(self, svstate, costs, generator=None, steps=-1):
        """Selection, roll and prior refresh on the whole (tiny)
        per-particle quantities; delegates to the wrapped SVMPC."""
        return self.svmpc.forward(svstate, costs, generator=generator,
                                  steps=steps)
