"""The streamed GMM prior score for large particle counts (K12):
counterpart of `dust_tpu/ops/pallas_gmm.py`.

    score_i = sum_k r_ik (c_k - x_i) / bw^2,
    r_ik    = softmax_k(-|x_i - c_k|^2 / (2 bw^2))

(the gradient of MPF's uniform-mixture prior around the centers), without
storing the [m, k] responsibilities.

* On CUDA tensors `gmm_prior_score_streamed` and
  `gmm_prior_score_streamed_packed` launch one hand-written kernel,
  `csrc/gmm_score.cu` (which replaces both TPU kernels of
  `dust_tpu/ops/pallas_gmm.py`): for d <= 8 a thread-block cluster per row
  tile, every warp walking its own slice of the centers
  (`ops/stream_split.py`) with an online softmax rescaled once per tile of
  TILE_COLS centers, the warps' states merged in a fixed order; for 8 < d
  <= 128 a thread per row; above d = 128 (the general entry only) a block
  per 16 rows over d-chunks of 128 (`csrc/stream_dchunk.cuh`); each entry
  counted in its own `.launches`.
* On CPU tensors they run `gmm_prior_score_plain`, the same function in
  plain PyTorch: explicit per-dimension distances, a softmax, and the
  centers shifted by the first one (shift-invariant, exact far from the
  origin); `use_bf16` rounds the unnormalized weights and the shifted
  centers to bf16 before the products, with f32 sums, as the TPU packed
  kernel does, each weight against the max the kernel forms it against
  (`_bf16_weights`).

`gmm_prior_score_reference` is the oracle (`pallas_gmm.py:37`).
`TILE_COLS` and `column_split` (from `ops/stream_split.py`) are the slice
and tile sizes that the kernel and the bf16 rule share.
"""

from __future__ import annotations

import torch

from .distance import squared_distance
from .stream_split import TILE_COLS, column_split
from .svgd import MAX_PACKED_D, _bf16, _check_blocks


def gmm_prior_score_reference(x, centers, bw):
    """The oracle: grad log sum_k N(x | c_k, bw^2 I) w.r.t. x."""
    logits = -squared_distance(x, centers) / (2.0 * bw ** 2)
    r = torch.softmax(logits, dim=1)
    return (r @ centers - x) / (bw ** 2)


def gmm_prior_score_plain(x, centers, bw, use_bf16=False):
    """Plain PyTorch version of the kernel. x [m, d], centers [k, d], bw
    scalar (number or tensor). Returns the score [m, d]."""
    bw = torch.as_tensor(bw, dtype=torch.float32, device=x.device)
    inv2 = 0.5 / (bw * bw)
    d2 = None
    for dd in range(x.shape[1]):
        diff = (x[:, dd, None] - centers[None, :, dd]) ** 2
        d2 = diff if d2 is None else d2 + diff
    logits = -d2 * inv2
    cc = centers - centers[0]
    if use_bf16:
        p = _bf16_weights(logits)
        cc = _bf16(cc)
    else:
        p = torch.exp(logits - logits.amax(dim=1, keepdim=True))
    mean_c = (p @ cc) / p.sum(dim=1, keepdim=True)
    return (mean_c - (x - centers[0])) * (2.0 * inv2)


def _bf16_weights(logits):
    """The kernel's bf16 weights [m, k], rescaled to the row's max: the
    warp that walks center j (`column_split`'s slice of it) rounds
    exp(logit_j - M) to bf16, M the running max of its slice's logits up to
    the end of j's tile of TILE_COLS centers (the state is rescaled once per
    tile, before the tile's weights), and the merges rescale the f32 sums by
    exp(M - max)."""
    m, k = logits.shape
    width = column_split(k)[1]
    n_tiles = -(-k // TILE_COLS)
    per_slice = width // TILE_COLS
    n_slices = -(-n_tiles // per_slice)
    pad = n_slices * per_slice * TILE_COLS - k
    tiles = torch.nn.functional.pad(logits, (0, pad), value=-torch.inf)
    tmax = tiles.view(m, n_slices, per_slice, TILE_COLS).amax(dim=3)
    run = torch.cummax(tmax, dim=2).values.view(m, -1)
    run = run.repeat_interleave(TILE_COLS, dim=1)[:, :k]
    top = logits.amax(dim=1, keepdim=True)
    return _bf16(torch.exp(logits - run)) * torch.exp(run - top)


def _launch(wrapper, x, centers, bw, use_bf16, what, max_d=None):
    if x.ndim != 2 or centers.ndim != 2 or centers.shape[1] != x.shape[1]:
        raise ValueError(f"{what}: x [m, d] and centers [k, d]")
    if max_d is not None and x.shape[1] > max_d:
        raise ValueError(f"{what}: requires d <= {max_d}")
    if x.device.type == "cpu":
        return gmm_prior_score_plain(x, centers, bw, use_bf16=use_bf16)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (x.dtype != torch.float32 or centers.dtype != torch.float32
            or centers.device != x.device):
        raise ValueError("x and centers must be float32 on one device")
    from ._build import check, load_library

    m, d = x.shape
    x = x.contiguous()
    centers = centers.contiguous()
    bw_t = torch.as_tensor(bw, dtype=torch.float32,
                           device=x.device).reshape(1)
    out = torch.empty_like(x)
    rc = load_library().dust_gmm_score(
        x.data_ptr(), centers.data_ptr(), bw_t.data_ptr(), out.data_ptr(), m,
        centers.shape[0], d, int(bool(use_bf16)),
        torch.cuda.current_stream(x.device).cuda_stream)
    wrapper.launches += 1
    check(rc, "gmm_score")
    return out


def gmm_prior_score_streamed(x, centers, bw, block_i=256, block_k=1024):
    """Counterpart of `gmm_prior_score_pallas` (pallas_gmm.py:97): the
    score for x [m, d] (any d), centers [k, d], bw scalar.
    `block_i`/`block_k` are TPU tile sizes: validated, no effect. Counted
    in `gmm_prior_score_streamed.launches`."""
    _check_blocks(block_i=block_i, block_k=block_k)
    return _launch(gmm_prior_score_streamed, x, centers, bw, False,
                   "gmm_prior_score_streamed")


def gmm_prior_score_streamed_packed(x, centers, bw, block_i=256,
                                    block_k=1024, use_bf16=False):
    """Counterpart of `gmm_prior_score_pallas_packed` (pallas_gmm.py:201):
    the same function for d <= 8, with optional bf16 products. Counted in
    `gmm_prior_score_streamed_packed.launches`."""
    _check_blocks(block_i=block_i, block_k=block_k)
    return _launch(gmm_prior_score_streamed_packed, x, centers, bw, use_bf16,
                   "packed GMM layout", MAX_PACKED_D)


gmm_prior_score_streamed.launches = 0
gmm_prior_score_streamed_packed.launches = 0
