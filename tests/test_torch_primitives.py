"""Port primitives (`dust_tpu_torch.distributions`, `ops.bandwidth`,
`ops.kernels`, `ops.distance`) against their `dust_tpu` counterparts on the
same float32 inputs, built with numpy from a seed.

Tolerance: rtol 1e-5, atol 1e-6 (float32, same formulas; only the order
of reductions differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu import distributions as jd
from dust_tpu.ops import bandwidth as jbw
from dust_tpu.ops import kernels as jk
from dust_tpu.ops.distance import squared_distance as j_sqdist
from dust_tpu_torch import distributions as td
from dust_tpu_torch.ops import bandwidth as tbw
from dust_tpu_torch.ops import kernels as tk
from dust_tpu_torch.ops.distance import squared_distance as t_sqdist

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # tiny tensors: the intra-op thread pool only adds latency
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _close(ours, theirs, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(
        ours.detach().numpy(), np.asarray(theirs), rtol=rtol, atol=atol
    )


def _cov(rng, d):
    a = rng.normal(size=(d, d)).astype(np.float32)
    return (a @ a.T + d * np.eye(d)).astype(np.float32)


def test_mvn_log_prob_and_covariance():
    rng = np.random.default_rng(0)
    loc = rng.normal(size=(3,)).astype(np.float32)
    cov = _cov(rng, 3)
    x = rng.normal(size=(7, 3)).astype(np.float32)
    j = jd.MVN.from_cov(loc, cov)
    t = td.MVN.from_cov(loc, cov)
    _close(t.log_prob(_t(x)), j.log_prob(jnp.asarray(x)))
    _close(t.covariance, j.covariance)


@pytest.mark.parametrize("event_ndims", [0, 1])
def test_normal_log_prob(event_ndims):
    rng = np.random.default_rng(1)
    loc = rng.normal(size=(4, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=(4, 2)).astype(np.float32)
    x = rng.normal(size=(5, 4, 2)).astype(np.float32)
    j = jd.Normal(jnp.asarray(loc), jnp.asarray(scale), event_ndims)
    t = td.Normal(_t(loc), _t(scale), event_ndims)
    _close(t.log_prob(_t(x)), j.log_prob(jnp.asarray(x)))
    assert tuple(t.event_shape) == tuple(j.event_shape)


def test_uniform_log_prob_mean_and_sample_support():
    rng = np.random.default_rng(2)
    low = np.array([0.6, 0.6], np.float32)
    high = np.array([1.3, 1.3], np.float32)
    x = rng.uniform(0.4, 1.5, size=(9, 2)).astype(np.float32)
    j = jd.Uniform(jnp.asarray(low), jnp.asarray(high), event_ndims=1)
    t = td.Uniform(_t(low), _t(high), event_ndims=1)
    np.testing.assert_array_equal(t.log_prob(_t(x)).numpy(),
                                  np.asarray(j.log_prob(jnp.asarray(x))))
    _close(t.mean, j.mean)
    draws = t.sample(torch.Generator().manual_seed(0), (100,))
    assert draws.shape == (100, 2)
    assert bool(((draws >= 0.6) & (draws < 1.3)).all())


@pytest.mark.parametrize("event", [(2,), (6, 1)], ids=["mpf_k2", "policy_kH1"])
def test_gmm_log_prob_score_mean(event):
    """Both event shapes of the path: [k, 2] (MPF prior) and [k, H, 1]
    (policy prior, middle axes summed)."""
    rng = np.random.default_rng(3)
    k, d = 5, event[-1]
    locs = rng.normal(size=(k, *event)).astype(np.float32)
    weights = rng.uniform(0.5, 1.5, size=(k,)).astype(np.float32)
    cov = (0.7 * np.eye(d)).astype(np.float32) if d == 1 else _cov(rng, d)
    x = rng.normal(size=(4, *event)).astype(np.float32)
    j = jd.GMM.from_cov(locs, weights, cov)
    t = td.GMM.from_cov(locs, weights, cov)
    _close(t.logits, j.logits)
    _close(t.log_prob(_t(x)), j.log_prob(jnp.asarray(x)))
    _close(t.score(_t(x)), j.score(jnp.asarray(x)))
    _close(t.mean, j.mean)


def test_gmm_score_equals_autograd_of_log_prob():
    rng = np.random.default_rng(4)
    locs = rng.normal(size=(6, 2)).astype(np.float32)
    t = td.GMM.from_cov(locs, np.ones(6, np.float32),
                        (0.3 * np.eye(2)).astype(np.float32))
    x = _t(rng.normal(size=(5, 2)))
    auto = torch.func.grad(lambda v: t.log_prob(v).sum())(x)
    np.testing.assert_allclose(t.score(x).numpy(), auto.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_gmm_sample_shape_and_moments():
    locs = _t([[0.0, 0.0], [10.0, 10.0]])
    t = td.GMM(locs=locs, scale_tril=0.1 * torch.eye(2),
               logits=torch.log(_t([0.25, 0.75])))
    draws = t.sample(torch.Generator().manual_seed(0), (4000,))
    assert draws.shape == (4000, 2)
    frac_far = (draws[:, 0] > 5.0).float().mean().item()
    assert abs(frac_far - 0.75) < 0.03


@pytest.mark.parametrize("n", [10, 11], ids=["even", "odd"])
def test_median_and_silverman_rules(n):
    rng = np.random.default_rng(5 + n)
    x = rng.normal(size=(n, 2)).astype(np.float32)
    _close(tbw.median_lower(_t(x)), jbw.median_lower(jnp.asarray(x)))
    _close(tbw.silvermans_rule(_t(x)), jbw.silvermans_rule(jnp.asarray(x)))
    _close(tbw.select_sigma(_t(x)), jbw.select_sigma(jnp.asarray(x)))
    _close(tbw.bw_silverman(_t(x)), jbw.bw_silverman(jnp.asarray(x)))
    _close(tbw.bw_median(_t(x)), jbw.bw_median(jnp.asarray(x)))


def test_bw_silverman_vector_when_std_wins():
    """Columns with very different spreads: the IQR of the flattened data
    exceeds the smaller column std, so the per-column std vector wins."""
    rng = np.random.default_rng(6)
    x = np.stack([rng.normal(size=20) * 0.01,
                  rng.normal(size=20) * 3.0], 1).astype(np.float32)
    j = jbw.bw_silverman(jnp.asarray(x))
    t = tbw.bw_silverman(_t(x))
    assert t.shape == (2,) and not np.isclose(*np.asarray(j))
    _close(t, j)


def test_squared_distance_and_rbf_gram_and_grad():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(9, 3)) + 5.0).astype(np.float32)
    y = rng.normal(size=(9, 3)).astype(np.float32)
    # rows ~5 from the origin: the Gram identity and the gradient's
    # k @ y - rowsum(k) * x both cancel terms of that size, leaving a few
    # ulp of them (measured 3e-6), hence atol 1e-5 for these two only
    _close(t_sqdist(_t(x), _t(y)), j_sqdist(jnp.asarray(x), jnp.asarray(y)),
           atol=1e-5)
    for bw in (0.4, 1.7):
        tk_, tg = tk.rbf_gram_and_grad(_t(x), _t(x), torch.tensor(bw))
        jk_, jg = jk.rbf_gram_and_grad(jnp.asarray(x), jnp.asarray(x),
                                       jnp.float32(bw))
        _close(tk_, jk_)
        _close(tg, jg, atol=1e-5)
        _close(tk.rbf_gram(_t(x), _t(x), bw), jk.rbf_gram(x, x, bw))


@pytest.mark.parametrize("ell", [-1.0, 0.8])
def test_rbf_analytic(ell):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(8, 2)).astype(np.float32)
    tk_, tdk, th = tk.rbf_analytic(_t(x), _t(x), ell=ell)
    jk_, jdk, jh = jk.rbf_analytic(jnp.asarray(x), jnp.asarray(x), ell=ell)
    _close(th, jh)
    _close(tk_, jk_)
    _close(tdk, jdk)


@pytest.mark.parametrize("indep", [True, False])
def test_iid_mp(indep):
    rng = np.random.default_rng(9)
    m, h, d = 5, 4, 2
    x = rng.normal(size=(m, h * d)).astype(np.float32)
    tk_, tdk = tk.iid_mp(_t(x), _t(x), d, indep_controls=indep)
    jk_, jdk = jk.iid_mp(jnp.asarray(x), jnp.asarray(x), d,
                         indep_controls=indep)
    assert tk_.shape == jk_.shape == (m, m, h * d)
    _close(tk_, jk_)
    _close(tdk, jdk)
