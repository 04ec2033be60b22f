"""K11: the port's streamed SVGD direction (whose wrappers run the
kernel's plain version on CPU tensors) against the JAX oracle and all
three JAX Pallas kernels in interpret mode (mirrors tests/test_pallas.py),
and the dispatcher.

Tolerances are tests/test_pallas.py's: rtol 2e-4, atol 2e-5 against the
oracle and the kernels; far from the origin atol 2e-3 (the f32
quantization of the offset inputs); bf16 products atol 5e-3 times the
largest |phi|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.ops.pallas_svgd import (
    svgd_phi_pallas,
    svgd_phi_pallas_packed,
    svgd_phi_pallas_symm,
    svgd_phi_reference,
)
from dust_tpu_torch.ops import svgd

TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, d, seed, offset=0.0, score_scale=5.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32) + np.float32(offset)
    score = (rng.normal(size=(m, d)) * score_scale).astype(np.float32)
    return x, score


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("m,d", [(64, 2), (200, 3), (512, 2), (300, 60)])
def test_streamed_phi_matches_oracle_and_gram_kernel(m, d):
    x, score = _inputs(m, d, seed=m + d)
    got = svgd.svgd_phi_streamed(_t(x), _t(score), 0.7).numpy()
    oracle = np.asarray(svgd_phi_reference(jnp.asarray(x), jnp.asarray(score),
                                           0.7))
    kernel = np.asarray(svgd_phi_pallas(x, score, 0.7, block_i=128,
                                        block_j=128, interpret=True))
    np.testing.assert_allclose(got, oracle, **TOL)
    np.testing.assert_allclose(got, kernel, **TOL)
    # the port's oracle is JAX's
    np.testing.assert_allclose(
        svgd.svgd_phi_reference(_t(x), _t(score), 0.7).numpy(), oracle,
        **TOL)


def test_streamed_phi_odd_sizes():
    x, score = _inputs(137, 5, seed=1, score_scale=1.0)
    got = svgd.svgd_phi_streamed(_t(x), _t(score), 1.3).numpy()
    kernel = np.asarray(svgd_phi_pallas(x, score, 1.3, block_i=128,
                                        block_j=128, interpret=True))
    np.testing.assert_allclose(got, kernel, **TOL)


def test_streamed_phi_far_from_origin():
    """Explicit differences and the first-particle shift keep phi exact
    far from the origin (tests/test_pallas.py:37-52)."""
    x, score = _inputs(256, 3, seed=2, score_scale=1.0)
    x = x * np.float32(0.2)
    near = svgd.svgd_phi_streamed(_t(x), _t(score), 0.5).numpy()
    far = svgd.svgd_phi_streamed(_t(x + np.float32(2000.0)), _t(score),
                                 0.5).numpy()
    np.testing.assert_allclose(far, near, atol=2e-3)
    j_far = np.asarray(svgd_phi_pallas(x + np.float32(2000.0), score, 0.5,
                                       block_i=128, block_j=128,
                                       interpret=True))
    np.testing.assert_allclose(far, j_far, atol=2e-3)


@pytest.mark.parametrize("m,d", [(64, 2), (137, 5), (512, 2), (300, 1)])
def test_streamed_phi_packed_matches_packed_kernel(m, d):
    x, score = _inputs(m, d, seed=3 * m + d, offset=1.5)
    got = svgd.svgd_phi_streamed_packed(_t(x), _t(score), 0.7).numpy()
    kernel = np.asarray(svgd_phi_pallas_packed(x, score, 0.7, block_i=128,
                                               block_j=128, interpret=True))
    oracle = np.asarray(svgd_phi_reference(jnp.asarray(x), jnp.asarray(score),
                                           0.7))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("m,d", [(64, 2), (137, 5), (300, 1), (700, 2)])
def test_streamed_phi_symm_matches_symm_kernel(m, d):
    x, score = _inputs(m, d, seed=5 * m + d, offset=1.5)
    got = svgd.svgd_phi_streamed_symm(_t(x), _t(score), 0.7).numpy()
    kernel = np.asarray(svgd_phi_pallas_symm(x, score, 0.7, block=128,
                                             interpret=True))
    np.testing.assert_allclose(got, kernel, **TOL)


def test_streamed_phi_packed_bf16_tolerance():
    x, score = _inputs(512, 2, seed=7)
    oracle = np.asarray(svgd_phi_reference(jnp.asarray(x), jnp.asarray(score),
                                           0.7))
    scale = float(np.abs(oracle).max())
    got = svgd.svgd_phi_streamed_packed(_t(x), _t(score), 0.7,
                                        use_bf16=True).numpy()
    kernel = np.asarray(svgd_phi_pallas_packed(x, score, 0.7, block_i=128,
                                               block_j=128, use_bf16=True,
                                               interpret=True))
    np.testing.assert_allclose(got, oracle, atol=5e-3 * scale)
    np.testing.assert_allclose(got, kernel, atol=5e-3 * scale)
    # the rounding acts: the bf16 result is not the f32 one
    f32 = svgd.svgd_phi_streamed_packed(_t(x), _t(score), 0.7).numpy()
    assert np.abs(got - f32).max() > 1e-6


def test_plain_rows_slice_equals_full():
    x, score = _inputs(300, 2, seed=8)
    full = svgd.svgd_phi_plain(_t(x), _t(score), 0.7)
    part = svgd.svgd_phi_plain(_t(x), _t(score), 0.7, rows=slice(100, 250))
    assert torch.equal(part, full[100:250])


def test_dispatcher_and_guards():
    x, score = _inputs(600, 2, seed=9)
    # on CPU tensors the dispatcher takes the oracle at any m (on the card
    # it launches the kernel at any m; chip_smoke.py checks that)
    for m in (600, 100):
        got = svgd.fused_svgd_phi(_t(x[:m]), _t(score[:m]), 0.7)
        want = svgd.svgd_phi_reference(_t(x[:m]), _t(score[:m]), 0.7)
        assert torch.equal(got, want)
    counts = (svgd.svgd_phi_streamed.launches,
              svgd.svgd_phi_streamed_packed.launches,
              svgd.svgd_phi_streamed_symm.launches)
    svgd.svgd_phi_streamed(_t(x), _t(score), 0.7)
    assert counts == (svgd.svgd_phi_streamed.launches,
                      svgd.svgd_phi_streamed_packed.launches,
                      svgd.svgd_phi_streamed_symm.launches)
    x9, s9 = (torch.zeros(16, 9) for _ in range(2))
    for fn in (svgd.svgd_phi_streamed_packed, svgd.svgd_phi_streamed_symm):
        with pytest.raises(ValueError, match="d <= 8"):
            fn(x9, s9, 0.7)
    # any d: above 128 the general entry takes the same plain version
    # (test_streamed_phi_above_d128_matches_jax holds it against JAX)
    x129, s129 = _inputs(4, 129, seed=10)
    np.testing.assert_allclose(
        svgd.svgd_phi_streamed(_t(x129), _t(s129), 9.0).numpy(),
        svgd.svgd_phi_reference(_t(x129), _t(s129), 9.0).numpy(), **TOL)
    with pytest.raises(ValueError, match=r"\[m, d\]"):
        svgd.svgd_phi_streamed(torch.zeros(4, 2), torch.zeros(4, 3), 1.0)
    with pytest.raises(ValueError, match="block_j"):
        svgd.svgd_phi_streamed(_t(x), _t(score), 0.7, block_j=0)


@pytest.mark.parametrize("d", [129, 200])
def test_streamed_phi_above_d128_matches_jax(d):
    """The general entry above d = 128 (the card's d-chunked path,
    csrc/stream_dchunk.cuh) against JAX's `svgd_phi_pallas` in interpret
    mode and the oracle, m = 40, with a bandwidth of 0.7 sqrt(d) so that
    the kernel values stay away from 0 and 1."""
    x, score = _inputs(40, d, seed=d)
    bw = 0.7 * float(np.sqrt(d))
    got = svgd.svgd_phi_streamed(_t(x), _t(score), bw).numpy()
    kernel = np.asarray(svgd_phi_pallas(x, score, bw, block_i=128,
                                        block_j=128, interpret=True))
    oracle = np.asarray(svgd_phi_reference(jnp.asarray(x),
                                           jnp.asarray(score), bw))
    np.testing.assert_allclose(got, kernel, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)
    k = np.exp(-((x[:, None] - x[None]) ** 2).sum(-1) / (2 * bw * bw))
    assert 0.01 < k[~np.eye(40, dtype=bool)].mean() < 0.9


@pytest.mark.parametrize("offset", [0.0, 1.5, 2000.0])
def test_plain_difference_form_matches_jax(offset):
    """The float32 plain version (the kernel's difference form, sum_j K_ij
    (x_i - x_j)) against JAX's oracle and kernel at m = 137, d = 5, near
    and far from the origin (far: the f32 quantization of the offset
    inputs bounds the error, tests/test_pallas.py:37-52)."""
    x, score = _inputs(137, 5, seed=21, score_scale=1.0)
    x = x * np.float32(0.3) + np.float32(offset)
    got = svgd.svgd_phi_plain(_t(x), _t(score), 0.6).numpy()
    kernel = np.asarray(svgd_phi_pallas(x, score, 0.6, block_i=128,
                                        block_j=128, interpret=True))
    oracle = np.asarray(svgd_phi_reference(jnp.asarray(x), jnp.asarray(score),
                                           0.6))
    tol = TOL if offset < 100 else dict(rtol=0.0, atol=2e-3)
    np.testing.assert_allclose(got, kernel, **tol)
    np.testing.assert_allclose(got, oracle, **tol)
    near = svgd.svgd_phi_plain(_t(x - np.float32(offset)), _t(score),
                               0.6).numpy()
    np.testing.assert_allclose(got, near, atol=2e-3)


@pytest.mark.parametrize("m,d", [(137, 5), (300, 1), (64, 8)])
def test_bf16_plain_matches_packed_kernel(m, d):
    """The bf16 branch (K, the scores and x - x_0 rounded, f32 sums and
    the row sum) against JAX's packed kernel with bf16 products."""
    x, score = _inputs(m, d, seed=4 * m + d, offset=1.5)
    oracle = np.asarray(svgd_phi_reference(jnp.asarray(x), jnp.asarray(score),
                                           0.7))
    scale = float(np.abs(oracle).max())
    got = svgd.svgd_phi_plain(_t(x), _t(score), 0.7, use_bf16=True).numpy()
    kernel = np.asarray(svgd_phi_pallas_packed(x, score, 0.7, block_i=128,
                                               block_j=128, use_bf16=True,
                                               interpret=True))
    np.testing.assert_allclose(got, kernel, atol=5e-3 * scale)
    np.testing.assert_allclose(got, oracle, atol=5e-3 * scale)


def _walk_phi(x, score, bw, use_bf16):
    """The kernel's walk written out with ops/stream_split.py's constants:
    warp w of the block of cluster rank b sums its slice of `column_split`'s
    width, particle by particle in order (K one exp, rounded to bf16 with
    the scores and x_j - x_0 when asked); the warps' sums merge in warp
    order, then the blocks' in rank order."""
    from dust_tpu_torch.ops.stream_split import SLICE_WARPS, column_split

    m, d = x.shape
    cluster, width = column_split(m)
    inv2 = 0.5 / bw ** 2
    n = 2 * d + 1
    blocks = []
    for b in range(cluster):
        warps = []
        for w in range(SLICE_WARPS):
            j0 = min(m, (b * SLICE_WARPS + w) * width)
            acc = torch.zeros(m, n)
            for j in range(j0, min(m, j0 + width)):
                diff = x - x[j]
                k = torch.exp(-(diff * diff).sum(1, keepdim=True) * inv2)
                if use_bf16:
                    k = svgd._bf16(k)
                    terms = [k * svgd._bf16(score[j]),
                             k * svgd._bf16(x[j] - x[0]), k]
                else:
                    terms = [k * score[j], k * diff, torch.zeros(m, 1)]
                acc = acc + torch.cat(terms, dim=1)
            warps.append(acc)
        blk = torch.zeros(m, n)
        for acc in warps:
            blk = blk + acc
        blocks.append(blk)
    tot = torch.zeros(m, n)
    for blk in blocks:
        tot = tot + blk
    drive, kx, rows = tot[:, :d], tot[:, d:2 * d], tot[:, 2 * d:]
    if use_bf16:
        return (drive + (rows * (x - x[0]) - kx) * (2 * inv2)) / m
    return (drive + kx * (2 * inv2)) / m


@pytest.mark.parametrize("m,use_bf16", [(300, False), (2049, False),
                                        (700, True)])
def test_split_walk_equals_plain(m, use_bf16):
    """K11's column split and merge order written out (one slice per warp,
    several blocks per cluster at m = 2049) against svgd_phi_plain: the
    split covers every particle once and the merges add up to the same
    function, up to reassociation."""
    x, score = _inputs(m, 2, seed=m, offset=0.5)
    x = x * np.float32(0.4)
    want = svgd.svgd_phi_plain(_t(x), _t(score), 0.5, use_bf16=use_bf16)
    got = _walk_phi(_t(x), _t(score), 0.5, use_bf16)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
