"""`dust_tpu_torch.utils.MerweScaledUTF` against `dust_tpu.utils.utf`.

Tolerances are tests/test_utf.py's: weights rtol 1e-5, sigma points atol
1e-4, the transform's mean atol 1e-4 and covariance atol 1e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.utils.utf import MerweScaledUTF as JUTF
from dust_tpu_torch.utils import MerweScaledUTF as TUTF


def _mean_cov(seed, n):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=n).astype(np.float32)
    a = rng.normal(size=(n, n)).astype(np.float32)
    return mu, (a @ a.T + np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("n, alpha, beta, kappa",
                         [(2, 0.5, 2.0, 0.0), (3, 1e-3, 2.0, 0.0),
                          (4, 0.8, 1.0, 1.0)])
def test_weights_match_jax(n, alpha, beta, kappa):
    j = JUTF(n=n, alpha=alpha, beta=beta, kappa=kappa)
    t = TUTF(n=n, alpha=alpha, beta=beta, kappa=kappa)
    assert t.pts == j.pts == 2 * n + 1
    np.testing.assert_allclose(t.loc_weights.numpy(),
                               np.asarray(j.loc_weights), rtol=1e-5)
    np.testing.assert_allclose(t.cov_weights.numpy(),
                               np.asarray(j.cov_weights), rtol=1e-5)
    assert t.loc_weights.dtype == torch.float32


@pytest.mark.parametrize("correct_sqrt", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_sigma_points_match_jax(n, correct_sqrt):
    mu, cov = _mean_cov(n, n)
    j = JUTF(n=n, alpha=0.5, correct_sqrt=correct_sqrt)
    t = TUTF(n=n, alpha=0.5, correct_sqrt=correct_sqrt)
    sp_j = np.asarray(j.compute_sigma_points(jnp.asarray(mu),
                                             jnp.asarray(cov)))
    sp_t = t.compute_sigma_points(torch.tensor(mu), torch.tensor(cov))
    assert sp_t.shape == (n, 2 * n + 1)
    np.testing.assert_allclose(sp_t.numpy(), sp_j, atol=1e-4)


@pytest.mark.parametrize("correct_sqrt", [False, True])
def test_unscented_transform_matches_jax(correct_sqrt):
    n = 3
    mu, cov = _mean_cov(7, n)
    j = JUTF(n=n, alpha=0.5, correct_sqrt=correct_sqrt)
    t = TUTF(n=n, alpha=0.5, correct_sqrt=correct_sqrt)
    sp = np.asarray(j.compute_sigma_points(jnp.asarray(mu),
                                           jnp.asarray(cov)))
    mu_j, cov_j = j.unscented_transform(jnp.asarray(sp))
    mu_t, cov_t = t.unscented_transform(torch.tensor(sp))
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), atol=1e-4)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), atol=1e-3)
    # the mean round-trips in both modes
    np.testing.assert_allclose(mu_t.numpy(), mu, atol=1e-4)


def test_correct_sqrt_mode_reconstructs_covariance():
    """correct_sqrt=True round-trips (mu, cov) through the transform; the
    default (the reference's upper-factor columns, PARITY.md #7) does
    not."""
    n = 3
    mu, cov = _mean_cov(11, n)
    fixed = TUTF(n=n, alpha=0.5, correct_sqrt=True)
    mu_out, cov_out = fixed.unscented_transform(
        fixed.compute_sigma_points(torch.tensor(mu), torch.tensor(cov)))
    np.testing.assert_allclose(mu_out.numpy(), mu, atol=1e-4)
    np.testing.assert_allclose(cov_out.numpy(), cov, rtol=1e-3, atol=1e-3)
    quirky = TUTF(n=n, alpha=0.5)
    _, cov_q = quirky.unscented_transform(
        quirky.compute_sigma_points(torch.tensor(mu), torch.tensor(cov)))
    assert not np.allclose(cov_q.numpy(), cov, rtol=1e-3, atol=1e-3)
