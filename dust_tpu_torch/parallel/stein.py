"""Particle-axis sharded SVGD (counterpart of
`dust_tpu/parallel/stein.py`).

The SVGD Gram matrix [m, m] is the one quadratic object of the framework.
For large particle counts it shards by rows: each rank owns m/p particles,
sees the (small, [m, d]) particles and scores of all, and computes only its
row block of K and the contractions, O(m^2/p) per rank.

`ShardedMPF` applies this to the dynamics posterior: the GMM prior around
the particles is the second O(m^2) object, handled the same way (the
rank's particles scored against all component centers). The row blocks
are torch products outside any kernel, as JAX's are jnp products outside
any Pallas kernel.

Each `make_*` function returns the global form: full tensors in on every
rank, the rank's block computed, the full result gathered on every rank
(one collective). Its `.local` attribute is the body for callers that hold
only their own rows: it gathers what it needs of the others' (the
particles and scores, or the centers and logits) itself, as JAX's
`shard_map` body does.
"""

from __future__ import annotations

import torch

from ..distributions import _LOG_2PI, _tril_log_det, _tril_solve, _tril_solve_t
from ..inference.mpf import MPF, MPFState
from .mesh import all_gather_rows, block


def svgd_phi_rows(x_local, score_local, bw, x_all, s_all):
    """The SVGD direction of the rows x_local [ml, d] against all particles
    x_all [m, d] and their scores s_all, standard sign and 1/m scale; no
    collective."""
    m = x_all.shape[0]
    bw = torch.as_tensor(bw, dtype=x_all.dtype, device=x_all.device)
    inv = 1.0 / (bw * bw)
    # center by the global mean: the Gram identity's cancellation error
    # grows with ||x||^2 while bw tracks only the spread (ops/distance.py);
    # K and the repulsion are translation invariant, so this is exact
    mu = x_all.mean(dim=0, keepdim=True).detach()
    x_local = x_local - mu
    x_all = x_all - mu
    d2 = ((x_local**2).sum(dim=1, keepdim=True)
          + (x_all**2).sum(dim=1)[None, :]
          - 2.0 * (x_local @ x_all.T))
    k = torch.exp(-torch.clamp(d2, min=0.0) * 0.5 * inv)    # [ml, m]
    drive = k @ s_all
    kx = k @ x_all
    rows = k.sum(dim=1, keepdim=True)
    repel = (rows * x_local - kx) * inv
    return (drive + repel) / m


def gmm_score_rows(x_local, locs_all, logits_all, scale_tril):
    """grad_x log p(x) of the rows x_local [ml, d] under the mixture of all
    centers locs_all [m, d] with shared [d, d] `scale_tril`
    (`distributions.GMM.score`, row-blocked). Materializes [ml, m, d]; no
    collective.

    The rows and the centers are whitened first (L^-1 x, L^-1 c: two
    solves of [ml, d] and [m, d]) and the [ml, m, d] differences taken
    after: L^-1 (x - c) = L^-1 x - L^-1 c, so no triangular solve runs
    over ml * m right-hand sides."""
    d = locs_all.shape[-1]
    log_w = torch.log_softmax(logits_all, dim=0)
    z = (_tril_solve(scale_tril, x_local)[:, None, :]
         - _tril_solve(scale_tril, locs_all)[None, :, :])  # [ml, m, d]
    maha = (z * z).sum(dim=-1)                              # [ml, m]
    lp = -0.5 * (maha + d * _LOG_2PI) - _tril_log_det(scale_tril)
    r = torch.softmax(lp + log_w, dim=-1)
    mean_c = r @ locs_all
    return _tril_solve_t(scale_tril, _tril_solve(scale_tril,
                                                 mean_c - x_local))


def make_sharded_svgd_phi(mesh, axis="particle"):
    """phi(x [m, d], score [m, d], bw) -> [m, d] on every rank, each rank
    computing its block of rows. `phi.local(x_local, score_local, bw)` is
    the body on the rank's own rows (two gathers, as JAX's)."""

    def local(x_local, score_local, bw):
        x_all = all_gather_rows(x_local, mesh, axis)
        s_all = all_gather_rows(score_local, mesh, axis)
        return svgd_phi_rows(x_local, score_local, bw, x_all, s_all)

    def phi(x, score, bw):
        rows = block(x.shape[0], mesh, axis)
        return all_gather_rows(
            svgd_phi_rows(x[rows], score[rows], bw, x, score), mesh, axis)

    phi.local = local
    return phi


def make_sharded_gmm_score(mesh, axis="particle"):
    """score(x [m, d], locs [m, d], logits [m], scale_tril [d, d]) ->
    [m, d] on every rank: the particle-centered mixture's score, each rank
    computing its row block. `score.local(x_local, locs_local,
    logits_local, scale_tril)` is the body on the rank's own rows (one
    gather of the centers and one of the logits)."""

    def local(x_local, locs_local, logits_local, scale_tril):
        locs_all = all_gather_rows(locs_local, mesh, axis)
        logits_all = all_gather_rows(logits_local, mesh, axis)
        return gmm_score_rows(x_local, locs_all, logits_all, scale_tril)

    def score(x, locs, logits, scale_tril):
        rows = block(x.shape[0], mesh, axis)
        return all_gather_rows(gmm_score_rows(x[rows], locs, logits,
                                              scale_tril), mesh, axis)

    score.local = local
    return score


class ShardedMPF(MPF):
    """MPF whose SVGD direction shards the particle axis over a mesh.

    Semantics = `MPF(reference_compat=False)`, but every [m, m] object
    (the kernel Gram, the GMM prior's responsibilities) is computed in row
    blocks, one per rank. The state stays whole on every rank (global in,
    global out); a step costs two collectives, the gather of the scores
    and the gather of the direction. The whole direction then goes
    through `MPF.step`'s optimizer on every rank alike, so an optimizer
    state (Adam's moments and count) stays whole and the same on every
    rank."""

    def __init__(self, likelihood, mesh, axis="particle", **kwargs):
        kwargs.pop("reference_compat", None)
        super().__init__(likelihood, reference_compat=False, **kwargs)
        self.mesh = mesh
        self.axis = axis

    def shard_state(self, mstate: MPFState) -> MPFState:
        """Check that the particle count divides by the axis size. The
        port keeps the particles whole on every rank and shards the work,
        so the state itself is returned as it is."""
        block(mstate.x.shape[0], self.mesh, self.axis)
        return mstate

    def phi(self, mstate: MPFState, bw):
        x = mstate.x
        prior = mstate.prior
        rows = block(x.shape[0], self.mesh, self.axis)
        x_local = x[rows]
        if prior.scale_tril.ndim == 2 and x.ndim == 2 \
                and prior.locs.shape == x.shape:
            # the particle-centered mixture: the rank's rows against all
            # centers
            grad_prior = gmm_score_rows(x_local, prior.locs, prior.logits,
                                        prior.scale_tril)
        else:   # other priors: the whole score, the rank's rows of it
            grad_prior = prior.score(x)[rows]
        score = self._grad_lik(mstate, x_local) + grad_prior
        s_all = all_gather_rows(score, self.mesh, self.axis)
        return all_gather_rows(svgd_phi_rows(x_local, score, bw, x, s_all),
                               self.mesh, self.axis)
