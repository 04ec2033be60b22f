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
from dust_tpu_torch.ops import _build, gmm
from dust_tpu_torch.ops.gmm import TILE_COLS, column_split

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


@pytest.mark.parametrize("m,k,d", [(512, 512, 2), (33, 70, 2),
                                   (300, 2100, 1), (200, 600, 8)])
def test_bf16_plain_matches_packed_kernel(m, k, d):
    """The bf16 plain version (the kernel's rounding rule: per warp slice,
    per tile of centers) against JAX's packed kernel with bf16 products, at
    one and at several slices per cluster and several clusters' worth of
    centers."""
    x, c = _inputs(m, k, d, seed=m + k, offset=0.8)
    oracle = np.asarray(gmm_prior_score_reference(jnp.asarray(x),
                                                  jnp.asarray(c), 0.4))
    scale = float(np.abs(oracle).max())
    got = gmm.gmm_prior_score_plain(_t(x), _t(c), 0.4, use_bf16=True)
    kernel = np.asarray(gmm_prior_score_pallas_packed(
        x, c, 0.4, block_i=128, block_k=128, use_bf16=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), kernel, atol=1.4e-2 * scale)


def _walk_bf16(logits, cc):
    """The kernel's walk written out: each warp slice of `column_split`'s
    width, its centers in tiles of TILE_COLS, one rescale per tile before
    the tile's bf16 weights, then the slices' states merged in order."""
    m, k = logits.shape
    width = column_split(k)[1]
    out = torch.empty(m, cc.shape[1])
    for i in range(m):
        states = []
        for j0 in range(0, k, width):
            mx, l, acc = -np.inf, torch.tensor(0.0), torch.zeros(cc.shape[1])
            for t0 in range(j0, min(k, j0 + width), TILE_COLS):
                t1 = min(k, j0 + width, t0 + TILE_COLS)
                new = max(mx, float(logits[i, t0:t1].max()))
                scale = torch.exp(torch.tensor(mx - new))
                l, acc, mx = l * scale, acc * scale, new
                p = gmm._bf16(torch.exp(logits[i, t0:t1] - mx))
                l, acc = l + p.sum(), acc + p @ cc[t0:t1]
            states.append((mx, l, acc))
        top = max(s[0] for s in states)
        l = sum(s[1] * np.exp(s[0] - top) for s in states)
        acc = sum(s[2] * np.exp(s[0] - top) for s in states)
        out[i] = acc / l
    return out


def test_bf16_rule_is_the_kernels_walk():
    """`gmm_prior_score_plain(use_bf16=True)` against the kernel's walk
    written out with the wrapper's slice and tile constants (the same ones
    `ops/_build.py` hands `nvcc`); k spans several slices with a ragged
    last tile, and the centers' order makes the running max grow from tile
    to tile, so a rule with other slices or tiles rounds differently."""
    assert column_split(2048) == (8, 32) and column_split(8192) == (8, 128)
    assert column_split(32768) == (8, 512) and column_split(200) == (1, 32)
    assert column_split(1) == (1, TILE_COLS)
    for k in (1, 33, 200, 2049, 8191, 32768):
        cluster, width = column_split(k)
        assert width % TILE_COLS == 0 and cluster * 8 * width >= k
    assert f"-DDUST_TILE_COLS={TILE_COLS}" in _build.NVCC_FLAGS
    x, c = _inputs(4, 403, 2, seed=7)
    c = c[np.argsort(-np.abs(c - x[0]).sum(axis=1))]    # nearest last
    bw = 0.3
    xt, ct = _t(x), _t(c)
    logits = -((xt[:, None, :] - ct[None]) ** 2).sum(-1) * (0.5 / bw ** 2)
    cc = gmm._bf16(ct - ct[0])
    want = (_walk_bf16(logits, cc) - (xt - ct[0])) / bw ** 2
    got = gmm.gmm_prior_score_plain(xt, ct, bw, use_bf16=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # against one running max over all centers (the previous rule) the
    # rounding differs
    run = torch.cummax(logits, dim=1).values
    p = gmm._bf16(torch.exp(logits - run)) * torch.exp(run - run[:, -1:])
    other = ((p @ cc) / p.sum(1, keepdim=True) - (xt - ct[0])) / bw ** 2
    assert (got - other).abs().max() > 1e-5


@pytest.mark.parametrize("m,k", [(1, 5), (33, 27), (1, 1), (130, 1371)])
def test_ragged_counts(m, k):
    """Both wrappers at m and k on no tile, slice or cluster boundary, and
    k != m, against the oracle and JAX's kernels."""
    x, c = _inputs(m, k, 2, seed=11 * m + k, offset=0.5)
    oracle = np.asarray(gmm_prior_score_reference(jnp.asarray(x),
                                                  jnp.asarray(c), 0.4))
    for got in (gmm.gmm_prior_score_streamed(_t(x), _t(c), 0.4),
                gmm.gmm_prior_score_streamed_packed(_t(x), _t(c), 0.4)):
        assert got.shape == (m, 2)
        np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    kernel = np.asarray(gmm_prior_score_pallas_packed(
        x, c, 0.4, block_i=128, block_k=128, interpret=True))
    np.testing.assert_allclose(kernel, oracle, **TOL)


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
