"""K12: the port's streamed GMM prior score (whose wrappers run the
kernel's plain version on CPU tensors) against the JAX oracle and both
JAX Pallas kernels in interpret mode (mirrors tests/test_pallas_gmm.py
:20-99).

Tolerances are tests/test_pallas_gmm.py's: rtol/atol 1e-4 against the
oracle and the kernels; far from the origin atol 5e-3. The bf16 products
have no JAX test; they are held at 1.4e-2 times the largest |score|, the
"~1.4% prior-score error" JAX measured for them
(dust_tpu/inference/mpf.py:379-380)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.ops.pallas_gmm import (
    gmm_prior_score_pallas,
    gmm_prior_score_pallas_packed,
    gmm_prior_score_reference,
)
from dust_tpu_torch.distributions import GMM
from dust_tpu_torch.ops import gmm

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _inputs(m, k, d, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32) + np.float32(offset)
    c = rng.normal(size=(k, d)).astype(np.float32)
    return x, c


@pytest.mark.parametrize("m,k,d", [(64, 64, 2), (200, 130, 3), (300, 300, 5)])
def test_streamed_score_matches_oracle_and_kernel(m, k, d):
    x, c = _inputs(m, k, d, seed=m + k + d)
    got = gmm.gmm_prior_score_streamed(_t(x), _t(c), 0.4).numpy()
    oracle = np.asarray(gmm_prior_score_reference(jnp.asarray(x),
                                                  jnp.asarray(c), 0.4))
    kernel = np.asarray(gmm_prior_score_pallas(x, c, 0.4, block_i=128,
                                               block_k=128, interpret=True))
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(
        gmm.gmm_prior_score_reference(_t(x), _t(c), 0.4).numpy(), oracle,
        **TOL)


def test_oracle_matches_gmm_autograd():
    """The streamed formula == autograd through the port's GMM.log_prob
    (tests/test_pallas_gmm.py:32-42)."""
    x, c = _inputs(40, 40, 2, seed=1)
    mix = GMM.from_cov(_t(c), torch.ones(40), 0.25 * torch.eye(2))
    auto = torch.func.grad(lambda t: mix.log_prob(t).sum())(_t(x))
    plain = gmm.gmm_prior_score_plain(_t(x), _t(c), 0.5)
    torch.testing.assert_close(plain, auto, **TOL)
    torch.testing.assert_close(gmm.gmm_prior_score_reference(_t(x), _t(c),
                                                             0.5), auto,
                               **TOL)


def test_streamed_score_far_from_origin():
    x, c = _inputs(192, 192, 2, seed=2)
    x, c = x * np.float32(0.3), c * np.float32(0.3)
    near = gmm.gmm_prior_score_streamed(_t(x), _t(c), 0.4).numpy()
    off = np.float32(3000.0)
    far = gmm.gmm_prior_score_streamed(_t(x + off), _t(c + off), 0.4).numpy()
    np.testing.assert_allclose(far, near, atol=5e-3)
    j_far = np.asarray(gmm_prior_score_pallas(x + off, c + off, 0.4,
                                              block_i=128, block_k=128,
                                              interpret=True))
    np.testing.assert_allclose(far, j_far, atol=5e-3)


@pytest.mark.parametrize("m,k,d", [(64, 64, 2), (200, 130, 3),
                                   (300, 300, 1)])
def test_streamed_score_packed_matches_packed_kernel(m, k, d):
    x, c = _inputs(m, k, d, seed=3 * m + d, offset=0.8)
    got = gmm.gmm_prior_score_streamed_packed(_t(x), _t(c), 0.4).numpy()
    kernel = np.asarray(gmm_prior_score_pallas_packed(
        x, c, 0.4, block_i=128, block_k=128, interpret=True))
    oracle = np.asarray(gmm_prior_score_reference(jnp.asarray(x),
                                                  jnp.asarray(c), 0.4))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


def test_streamed_score_packed_bf16():
    x, c = _inputs(512, 512, 2, seed=4)
    oracle = np.asarray(gmm_prior_score_reference(jnp.asarray(x),
                                                  jnp.asarray(c), 0.4))
    scale = float(np.abs(oracle).max())
    got = gmm.gmm_prior_score_streamed_packed(_t(x), _t(c), 0.4,
                                              use_bf16=True).numpy()
    kernel = np.asarray(gmm_prior_score_pallas_packed(
        x, c, 0.4, block_i=128, block_k=128, use_bf16=True, interpret=True))
    np.testing.assert_allclose(got, oracle, atol=1.4e-2 * scale)
    np.testing.assert_allclose(kernel, oracle, atol=1.4e-2 * scale)
    f32 = gmm.gmm_prior_score_streamed_packed(_t(x), _t(c), 0.4).numpy()
    assert np.abs(got - f32).max() > 1e-5


def test_general_d_and_guards():
    x, c = _inputs(100, 50, 12, seed=5)
    got = gmm.gmm_prior_score_streamed(_t(x), _t(c), 0.9).numpy()
    oracle = np.asarray(gmm_prior_score_reference(jnp.asarray(x),
                                                  jnp.asarray(c), 0.9))
    np.testing.assert_allclose(got, oracle, **TOL)
    with pytest.raises(ValueError, match="d <= 8"):
        gmm.gmm_prior_score_streamed_packed(_t(x), _t(c), 0.9)
    with pytest.raises(ValueError, match="centers"):
        gmm.gmm_prior_score_streamed(_t(x), _t(c[:, :3]), 0.9)
    with pytest.raises(ValueError, match="block_k"):
        gmm.gmm_prior_score_streamed(_t(x), _t(c), 0.9, block_k=0)
    before = gmm.gmm_prior_score_streamed.launches
    gmm.gmm_prior_score_streamed(_t(x), _t(c), 0.9)
    assert gmm.gmm_prior_score_streamed.launches == before
    assert jax.default_backend() == "cpu"
