"""The streamed SVGD direction for large particle counts (K11): counterpart
of `dust_tpu/ops/pallas_svgd.py`.

    K_ij  = exp(-|x_i - x_j|^2 / (2 bw^2))
    phi_i = (sum_j K_ij score_j
             + (rowsum(K)_i x_i - sum_j K_ij x_j) / bw^2) / m

(the standard SVGD direction of `MPF(reference_compat=False)`), without
storing K.

* On CUDA tensors `svgd_phi_streamed`, `svgd_phi_streamed_packed` and
  `svgd_phi_streamed_symm` launch one hand-written kernel,
  `csrc/svgd_phi.cu` (which replaces the three TPU kernels of
  `dust_tpu/ops/pallas_svgd.py`; they differ only in their TPU layouts):
  for d <= 8 a thread-block cluster per row tile, every warp walking its
  own slice of the particles (`ops/stream_split.py`), the sums merged in a
  fixed order; for 8 < d <= 128 a thread per row; above d = 128 (the
  general entry only) a block per 16 rows over d-chunks of 128
  (`csrc/stream_dchunk.cuh`); each entry counted in its own `.launches`.
* On CPU tensors they run `svgd_phi_plain`, the kernel's arithmetic in
  plain PyTorch: explicit per-dimension differences, which give both the
  distances and, in float32, the repulsion sum_j K_ij (x_i - x_j), so far
  from the origin stays exact; `use_bf16` rounds K, the scores and the
  particles shifted by the first one to bf16 before the products, with
  f32 sums and the row sum, as the TPU packed kernel does.

`svgd_phi_reference` is the oracle (the RBF Gram identity of
`ops/kernels.py`); `fused_svgd_phi` takes the kernel on the card and the
oracle on the CPU.
"""

from __future__ import annotations

import torch

from .kernels import rbf_gram_and_grad

# the TPU wrappers' packed operand holds [score | x | ones] in 128 lanes
MAX_PACKED_D = 8


def svgd_phi_reference(x, score, bw):
    """The oracle (`svgd_phi_reference` of pallas_svgd.py): the Gram
    matrix and its gradient, then (K @ score - grad) / m."""
    k, grad_first = rbf_gram_and_grad(x, x, bw)
    return (k @ score - grad_first) / x.shape[0]


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def svgd_phi_plain(x, score, bw, use_bf16=False, rows=slice(None)):
    """Plain PyTorch version of the kernel. x, score [m, d]; bw scalar
    (number or tensor); `rows` selects the rows of phi to compute (all by
    default; a slice keeps the [rows, m] matrices small at large m).
    Returns phi [m, d] (or its selected rows).

    Float32 takes the kernel's difference form, (K @ score + sum_j K_ij
    (x_i - x_j) / bw^2) / m; bf16 rounds K, the scores and the particles
    shifted by the first one before the products and keeps the row sum,
    (K @ score + (rowsum(K) (x_i - x_0) - K @ (x - x_0)) / bw^2) / m."""
    m, d = x.shape
    bw = torch.as_tensor(bw, dtype=torch.float32, device=x.device)
    inv2 = 0.5 / (bw * bw)
    xi = x[rows]
    diffs = [xi[:, dd, None] - x[None, :, dd] for dd in range(d)]
    d2 = None
    for diff in diffs:
        d2 = diff * diff if d2 is None else d2 + diff * diff
    k = torch.exp(-d2 * inv2)
    if not use_bf16:
        kx = torch.stack([(k * diff).sum(dim=1) for diff in diffs], dim=1)
        return (k @ score + kx * (2.0 * inv2)) * (1.0 / m)
    k, xc, s = _bf16(k), _bf16(x - x[0]), _bf16(score)
    drive, kx, rowsum = k @ s, k @ xc, k.sum(dim=1, keepdim=True)
    repel = (rowsum * (xi - x[0]) - kx) * (2.0 * inv2)
    return (drive + repel) * (1.0 / m)


def _check(x, score, what, max_d=None):
    if x.ndim != 2 or score.shape != x.shape:
        raise ValueError(f"{what}: x and score must both be [m, d]")
    if max_d is not None and x.shape[1] > max_d:
        raise ValueError(f"{what}: requires d <= {max_d}")


def _check_blocks(**blocks):
    for name, v in blocks.items():
        if int(v) < 1:
            raise ValueError(f"{name} must be a positive block size")


def _launch(wrapper, x, score, bw, use_bf16):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return svgd_phi_plain(x, score, bw, use_bf16=use_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (x.dtype != torch.float32 or score.dtype != torch.float32
            or score.device != x.device):
        raise ValueError("x and score must be float32 on one device")
    from ._build import check, load_library

    m, d = x.shape
    x = x.contiguous()
    score = score.contiguous()
    bw_t = torch.as_tensor(bw, dtype=torch.float32,
                           device=x.device).reshape(1)
    phi = torch.empty_like(x)
    rc = load_library().dust_svgd_phi(
        x.data_ptr(), score.data_ptr(), bw_t.data_ptr(), phi.data_ptr(), m,
        d, int(bool(use_bf16)),
        torch.cuda.current_stream(x.device).cuda_stream)
    wrapper.launches += 1
    check(rc, "svgd_phi")
    return phi


def svgd_phi_streamed(x, score, bw, block_i=256, block_j=1024):
    """Counterpart of `svgd_phi_pallas` (pallas_svgd.py:100): phi for x,
    score [m, d] (any d), bw scalar. `block_i`/`block_j` are TPU tile
    sizes: validated, no effect. Counted in
    `svgd_phi_streamed.launches`."""
    _check(x, score, "svgd_phi_streamed")
    _check_blocks(block_i=block_i, block_j=block_j)
    return _launch(svgd_phi_streamed, x, score, bw, False)


def svgd_phi_streamed_packed(x, score, bw, block_i=256, block_j=1024,
                             use_bf16=False):
    """Counterpart of `svgd_phi_pallas_packed` (pallas_svgd.py:197): the
    same function for d <= 8, with optional bf16 products. Counted in
    `svgd_phi_streamed_packed.launches`."""
    _check(x, score, "packed phi layout", MAX_PACKED_D)
    _check_blocks(block_i=block_i, block_j=block_j)
    return _launch(svgd_phi_streamed_packed, x, score, bw, use_bf16)


def svgd_phi_streamed_symm(x, score, bw, block=512):
    """Counterpart of `svgd_phi_pallas_symm` (pallas_svgd.py:310): the
    same function for d <= 8. The TPU kernel evaluates each pair once and
    mirrors it; on the card that would need atomics across blocks, so this
    launches the kernel of `svgd_phi_streamed_packed` (the values agree up
    to reassociation). Counted in `svgd_phi_streamed_symm.launches`."""
    _check(x, score, "packed phi layout", MAX_PACKED_D)
    _check_blocks(block=block)
    return _launch(svgd_phi_streamed_symm, x, score, bw, False)


def fused_svgd_phi(x, score, bw):
    """Counterpart of `fused_svgd_phi` (pallas_svgd.py:355): the kernel
    (`svgd_phi_streamed`) for CUDA tensors at any m, the oracle for CPU
    tensors. JAX's `min_particles_for_pallas` threshold is not taken: the
    kernel handles any m >= 1."""
    if x.device.type == "cpu":
        return svgd_phi_reference(x, score, bw)
    return svgd_phi_streamed(x, score, bw)


svgd_phi_streamed.launches = 0
svgd_phi_streamed_packed.launches = 0
svgd_phi_streamed_symm.launches = 0
