"""Merwe scaled unscented-transform sigma points (counterpart of
`dust_tpu/utils/utf.py`).

The weights are computed once at construction, in numpy float32 on the
host; `compute_sigma_points` and `unscented_transform` are tensor code on
the inputs' device (the Cholesky factor included), so they sit inside
MultiDisco's and AMPPI's sigma-point rollouts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributions import cholesky


class MerweScaledUTF:
    """Sigma-point transformer: 2n+1 points for an n-dim distribution.

    `correct_sqrt` selects the matrix square root:

    * False (default, the reference's convention, PARITY.md #7): the sigma
      offsets are the *columns* of the upper Cholesky factor U of
      (lambda + n) K. U^T U = (lambda + n) K, but the offsets reconstruct
      U U^T, so `unscented_transform` does not give K back.
    * True: the offsets are the columns of the lower factor L
      (L L^T = (lambda + n) K), and the sigma points round-trip (mu, K).
    """

    def __init__(self, n, alpha=1e-3, beta=2.0, kappa=0.0,
                 correct_sqrt=False):
        self.n = int(n)
        self.correct_sqrt = bool(correct_sqrt)
        self.pts = 2 * self.n + 1
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.kappa = float(kappa)

        lambda_ = self.alpha**2 * (self.n + self.kappa) - self.n
        c = 0.5 / (self.n + lambda_)
        cov_w = np.full((self.pts,), c, dtype=np.float32)
        loc_w = np.full((self.pts,), c, dtype=np.float32)
        cov_w[0] = lambda_ / (self.n + lambda_) + (1 - self.alpha**2
                                                   + self.beta)
        loc_w[0] = lambda_ / (self.n + lambda_)
        self._lambda = lambda_
        self._cov_w = cov_w
        self._loc_w = loc_w

    @property
    def cov_weights(self):
        """[2n+1] covariance weights (CPU float32)."""
        return torch.from_numpy(self._cov_w)

    @property
    def loc_weights(self):
        """[2n+1] mean weights (CPU float32)."""
        return torch.from_numpy(self._loc_w)

    def weights(self, device):
        """(loc_weights, cov_weights) on `device`."""
        return (torch.as_tensor(self._loc_w, device=device),
                torch.as_tensor(self._cov_w, device=device))

    def compute_sigma_points(self, mu, cov):
        """Sigma points [n, 2n+1] for mean `mu` [n] and covariance [n, n]:
        column 0 is the mean, columns 1..n are mu plus the columns of the
        square root, columns n+1..2n mu minus them."""
        mu = torch.as_tensor(mu, dtype=torch.float32).reshape(self.n)
        cov = torch.as_tensor(cov, dtype=torch.float32, device=mu.device)
        if self.correct_sqrt:
            u = cholesky((self._lambda + self.n) * cov)
        else:
            # chol(A^T)^T: the upper factor, the reference's quirk
            u = cholesky((self._lambda + self.n) * cov.T).T
        col = mu[:, None]
        return torch.cat([col, u + col, -u + col], dim=1)

    def unscented_transform(self, sigmas):
        """(mean [n], cov [n, n]) of transformed sigma points [n, 2n+1]."""
        loc_w, cov_w = self.weights(sigmas.device)
        mu = sigmas @ loc_w
        y = sigmas - mu[:, None]
        return mu, (y * cov_w) @ y.T
