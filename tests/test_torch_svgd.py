"""The generic `SVGD` of `dust_tpu_torch` against `dust_tpu`'s: `phi`
and `discrepancy` (rtol 1e-5), 20 optimizer steps with Adam against
`optax.adam(0.05)` and with SGD against `optax.sgd` (atol 1e-5), the
median bandwidth taken once and an explicit `bw` honoured, and
tests/test_inference.py's Gaussian convergence property."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dust_tpu.distributions import MVN as JMVN
from dust_tpu.inference import SVGD as JSVGD
from dust_tpu_torch.distributions import MVN as TMVN
from dust_tpu_torch.inference import SVGD as TSVGD


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _targets(d=2):
    loc = np.array([1.0, -1.0, 0.5][:d], np.float32)
    a = np.array([[0.5, 0.1, 0.0], [0.1, 2.0, 0.3], [0.0, 0.3, 1.0]],
                 np.float32)[:d, :d]
    return (JMVN.from_cov(jnp.asarray(loc), jnp.asarray(a)),
            TMVN.from_cov(_t(loc), _t(a)))


@pytest.mark.parametrize("d, n, bw", [(2, 10, 0.8), (3, 33, 1.7)])
def test_phi_and_discrepancy_match_jax(d, n, bw):
    x = np.random.default_rng(d).normal(size=(n, d)).astype(np.float32)
    jt, tt = _targets(d)
    phi_j = JSVGD().phi(jnp.asarray(x), jt.log_prob, bw)
    phi_t = TSVGD(device="cpu").phi(_t(x), tt.log_prob, bw)
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=1e-5,
                               atol=1e-7)
    d_j = JSVGD().discrepancy(jnp.asarray(x), jt.log_prob)
    d_t = TSVGD(device="cpu").discrepancy(_t(x), tt.log_prob)
    np.testing.assert_allclose(float(d_t), float(d_j), rtol=1e-5)
    np.testing.assert_allclose(
        TSVGD(device="cpu").score_matrix(_t(x), tt.log_prob).numpy(),
        np.asarray(JSVGD().score_matrix(jnp.asarray(x), jt.log_prob)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_steps_match_optax(optimizer):
    """20 steps through `step` with the optimizer state carried, the
    port's named optimizer against the optax one."""
    rng = np.random.default_rng(5)
    x0 = (2.0 * rng.normal(size=(16, 2))).astype(np.float32)
    jt, tt = _targets()
    opt = optax.adam(0.05) if optimizer == "adam" else optax.sgd(0.05)
    js = JSVGD(optimizer=opt)
    ts = TSVGD(optimizer=optimizer, lr=0.05, device="cpu")
    jx, jst = jnp.asarray(x0), js.optimizer.init(jnp.asarray(x0))
    tx, tst = _t(x0), ts.optimizer.init(_t(x0))
    for _ in range(20):
        jx, jst = js.step(jx, jst, jt.log_prob, 0.9)
        tx, tst = ts.step(tx, tst, tt.log_prob, 0.9)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    assert np.abs(tx.numpy() - x0).max() > 0.1   # the particles moved


@pytest.mark.parametrize("bw", [None, 0.6])
def test_optimize_matches_jax(bw):
    """The median bandwidth once up front (bw=None), or the given one;
    Adam at its default learning rate."""
    x0 = np.random.default_rng(6).normal(size=(12, 2)).astype(np.float32)
    jt, tt = _targets()
    jx = JSVGD(n_steps=20).optimize(jt.log_prob, initial_particles=x0,
                                    bw=bw)
    tx = TSVGD(n_steps=20, device="cpu").optimize(
        tt.log_prob, initial_particles=x0, bw=bw)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5)
    if bw is not None:
        other = TSVGD(n_steps=20, device="cpu").optimize(
            tt.log_prob, initial_particles=x0, bw=3.0 * bw)
        assert np.abs(other.numpy() - tx.numpy()).max() > 1e-4
    with pytest.raises(ValueError, match="optimizer"):
        TSVGD(optimizer="rmsprop", device="cpu")


def test_svgd_converges_to_gaussian():
    """Discrepancy decreases, the moments approach the target's."""
    target = TMVN.from_cov(_t([2.0, -1.0]), 0.5 * torch.eye(2))
    svgd = TSVGD(n_particles=64, n_steps=300, optimizer="adam", lr=0.05,
                 device="cpu")
    x0 = _t(np.random.default_rng(0).normal(size=(64, 2)) * 3.0)
    d0 = svgd.discrepancy(x0, target.log_prob)
    x = svgd.optimize(target.log_prob, initial_particles=x0, bw=None)
    d1 = svgd.discrepancy(x, target.log_prob)
    assert float(d1) < float(d0)
    np.testing.assert_allclose(x.numpy().mean(0), [2.0, -1.0], atol=0.15)
    np.testing.assert_allclose(x.numpy().var(0), [0.5, 0.5], atol=0.2)
    # a prior's draws in place of initial particles, from the generator
    y = TSVGD(n_particles=8, n_steps=2, device="cpu").optimize(
        target.log_prob, prior=target,
        generator=torch.Generator().manual_seed(0))
    assert y.shape == (8, 2) and np.isfinite(y.numpy()).all()
