"""Probability distributions on tensors (counterpart of
`dust_tpu/distributions.py`).

The family the DuSt stack uses, as frozen dataclasses of tensors:

* `MVN`     — full-covariance Gaussian on the last axis
* `Normal`  — elementwise Gaussian with `event_ndims` reinterpretation
* `Uniform` — box uniform with `event_ndims` reinterpretation
* `GMM`     — mixture of Gaussians sharing one covariance on the last axis,
              independent over middle event axes: `[k, 2]` for the MPF
              prior, `[k, H, 1]` for the policy prior.

`sample` takes an explicit `torch.Generator` where the JAX package takes a
key; the generator must live on the distribution's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def _tril_solve(scale_tril, x):
    """Solve L z = x along the last axis of x [..., d]; `scale_tril` is a
    shared [d, d] factor or batched with matching leading dims."""
    if scale_tril.ndim == 2:
        d = x.shape[-1]
        flat = x.reshape(-1, d)
        z = torch.linalg.solve_triangular(scale_tril, flat.T, upper=False)
        return z.T.reshape(x.shape)
    return torch.linalg.solve_triangular(
        scale_tril, x.unsqueeze(-1), upper=False
    ).squeeze(-1)


def _tril_solve_t(scale_tril, x):
    """Solve L^T z = x along the last axis (the second half of applying
    Sigma^-1 = L^-T L^-1); same batching contract as `_tril_solve`."""
    if scale_tril.ndim == 2:
        d = x.shape[-1]
        flat = x.reshape(-1, d)
        z = torch.linalg.solve_triangular(scale_tril.T, flat.T, upper=True)
        return z.T.reshape(x.shape)
    return torch.linalg.solve_triangular(
        scale_tril.transpose(-1, -2), x.unsqueeze(-1), upper=True
    ).squeeze(-1)


def _tril_log_det(scale_tril):
    return torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)).sum(-1)


def cholesky(a):
    """Lower Cholesky factor of `a` [..., d, d]. Where a matrix is not
    positive definite (a NaN in it included) the factor's lower triangle
    is NaN, as `jnp.linalg.cholesky` gives it, instead of an error: a
    diverged scenario stays in its own lane, and the card is not asked
    for the error flag."""
    factor, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(factor, math.nan).tril(), factor)


def _f32(value, device=None):
    return torch.as_tensor(value, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class MVN:
    """Multivariate normal over the last axis; `scale_tril` is a Cholesky
    factor of the covariance."""

    loc: torch.Tensor         # [..., d]
    scale_tril: torch.Tensor  # [..., d, d]

    @classmethod
    def from_cov(cls, loc, cov):
        loc = _f32(loc)
        cov = _f32(cov, loc.device)
        return cls(loc=loc, scale_tril=cholesky(cov))

    @property
    def event_shape(self):
        return self.loc.shape[-1:]

    @property
    def mean(self):
        return self.loc

    @property
    def covariance(self):
        return self.scale_tril @ self.scale_tril.transpose(-1, -2)

    def log_prob(self, x):
        d = self.loc.shape[-1]
        z = _tril_solve(self.scale_tril, x - self.loc)
        maha = (z * z).sum(-1)
        return -0.5 * (maha + d * _LOG_2PI) - _tril_log_det(self.scale_tril)

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        eps = torch.randn(shape, generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + torch.einsum("...ij,...j->...i", self.scale_tril,
                                       eps)


@dataclass(frozen=True)
class Normal:
    """Elementwise Gaussian. With `event_ndims=k`, `log_prob` sums over the
    trailing k axes."""

    loc: torch.Tensor
    scale: torch.Tensor
    event_ndims: int = 0

    @property
    def mean(self):
        return self.loc

    @property
    def event_shape(self):
        shape = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        return shape[len(shape) - self.event_ndims:]

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        lp = -0.5 * (z * z + _LOG_2PI) - torch.log(self.scale)
        if self.event_ndims:
            lp = lp.sum(dim=tuple(range(-self.event_ndims, 0)))
        return lp

    def sample(self, generator, sample_shape=()):
        base = torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        eps = torch.randn(tuple(sample_shape) + tuple(base),
                          generator=generator, dtype=self.loc.dtype,
                          device=self.loc.device)
        return self.loc + self.scale * eps


@dataclass(frozen=True)
class Uniform:
    """Box uniform on [low, high). With `event_ndims=k`, `log_prob` sums
    over the trailing k axes."""

    low: torch.Tensor
    high: torch.Tensor
    event_ndims: int = 0

    @property
    def mean(self):
        return (self.low + self.high) / 2.0

    def log_prob(self, x):
        inside = (x >= self.low) & (x < self.high)
        lp = torch.where(inside, -torch.log(self.high - self.low),
                         torch.full_like(x, -math.inf))
        if self.event_ndims:
            lp = lp.sum(dim=tuple(range(-self.event_ndims, 0)))
        return lp

    def sample(self, generator, sample_shape=()):
        base = torch.broadcast_shapes(self.low.shape, self.high.shape)
        u = torch.rand(tuple(sample_shape) + tuple(base), generator=generator,
                       dtype=self.low.dtype, device=self.low.device)
        return self.low + (self.high - self.low) * u


@dataclass(frozen=True)
class GMM:
    """Mixture of Gaussians with one shared covariance on the last axis.

    `locs` has shape [k, *event]; a Gaussian with Cholesky factor
    `scale_tril` ([d, d], d = event[-1]) sits at each component mean, and
    the middle event axes are independent (log-probs summed)."""

    locs: torch.Tensor        # [k, *event]
    scale_tril: torch.Tensor  # [d, d]
    logits: torch.Tensor      # [k]

    @classmethod
    def from_cov(cls, locs, weights, cov):
        locs = _f32(locs)
        cov = _f32(cov, locs.device)
        log_w = torch.log(_f32(weights, locs.device))
        logits = log_w - torch.logsumexp(log_w, dim=0)
        return cls(locs=locs, scale_tril=cholesky(cov),
                   logits=logits)

    @property
    def n_components(self):
        return self.locs.shape[0]

    @property
    def event_shape(self):
        return self.locs.shape[1:]

    @property
    def mean(self):
        w = torch.softmax(self.logits, dim=0)
        return torch.tensordot(w, self.locs, dims=1)

    def _component_log_prob(self, x):
        """log N(x | locs_k, Sigma) summed over all event axes:
        x [..., *event] -> [..., k]."""
        d = self.locs.shape[-1]
        n_event = self.locs.ndim - 1
        diff = x.unsqueeze(-n_event - 1) - self.locs
        z = _tril_solve(self.scale_tril, diff)
        maha = (z * z).sum(-1)
        lp = -0.5 * (maha + d * _LOG_2PI) - _tril_log_det(self.scale_tril)
        if n_event > 1:
            lp = lp.sum(dim=tuple(range(-(n_event - 1), 0)))
        return lp

    def log_prob(self, x):
        log_w = torch.log_softmax(self.logits, dim=0)
        return torch.logsumexp(self._component_log_prob(x) + log_w, dim=-1)

    def score(self, x):
        """grad_x log p(x) in closed form: sum_k r_k(x) Sigma^-1 (c_k - x),
        with responsibilities r = softmax(component log-probs + log w)."""
        log_w = torch.log_softmax(self.logits, dim=0)
        r = torch.softmax(self._component_log_prob(x) + log_w, dim=-1)
        mean_c = torch.tensordot(r, self.locs, dims=([-1], [0]))
        diff = mean_c - x
        return _tril_solve_t(self.scale_tril,
                             _tril_solve(self.scale_tril, diff))

    def sample(self, generator, sample_shape=()):
        shape = tuple(sample_shape)
        n = math.prod(shape)
        probs = torch.softmax(self.logits, dim=0)
        idx = torch.multinomial(probs, n, replacement=True,
                                generator=generator).reshape(shape)
        means = self.locs[idx]  # [*shape, *event]
        eps = torch.randn(means.shape, generator=generator,
                          dtype=means.dtype, device=means.device)
        return means + torch.einsum("ij,...j->...i", self.scale_tril, eps)
