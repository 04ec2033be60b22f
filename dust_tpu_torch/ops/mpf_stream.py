"""One FusedMPF SVGD iteration and the next iteration's prior score in one
launch (K13): counterpart of `dust_tpu/ops/pallas_mpf_stream.py`.

    x_new  = x + lr * phi(x, score)               (K11's phi, bandwidth bw)
    gp_new = gmm_score(x_new, centers, pbw)       (K12's score, bandwidth pbw)

* On CUDA tensors `fused_mpf_stream_step` launches the hand-written
  kernel `csrc/mpf_stream.cu` (which replaces the TPU kernel
  `fused_mpf_stream_step`): a thread-block cluster per row tile, every
  warp walking its own slice of the particles (`ops/stream_split.py`);
  the cluster merges phi, so each of its blocks holds the tile's x_new,
  and the same slices of the centers then give the prior score there.
  The TPU kernel's row pipeline (one row block's prior stream during the
  next block's phi) has no counterpart: no cluster waits on another.
* On CPU tensors it runs `mpf_stream_step_plain`: `svgd_phi_plain`, the
  SGD step, then `gmm_prior_score_plain`.
"""

from __future__ import annotations

import torch

from .gmm import gmm_prior_score_plain
from .svgd import MAX_PACKED_D, _check_blocks, svgd_phi_plain


def mpf_stream_step_plain(x, score, centers, bw, pbw, lr):
    """Plain PyTorch version of the kernel: (x_new, gp_new)."""
    x_new = x + lr * svgd_phi_plain(x, score, bw)
    return x_new, gmm_prior_score_plain(x_new, centers, pbw)


def fused_mpf_stream_step(x, score, centers, bw, pbw, lr, block_i=256,
                          block_j=8192):
    """x, score [m, d] (d <= 8); centers [m, d] (MPF priors are centered
    on the particles, so k == m); bw, pbw, lr scalars (numbers or
    tensors). Returns (x_new, gp_new) [m, d]. `block_i`/`block_j` are TPU
    tile sizes: validated, no effect. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in
    `fused_mpf_stream_step.launches`)."""
    m, d = x.shape
    if d > MAX_PACKED_D:
        raise ValueError("fused MPF stream layout requires d <= 8")
    if centers.shape[0] != m:
        raise ValueError("fused MPF stream expects k == m (MPF priors are "
                         "centered on the particles)")
    if score.shape != x.shape or centers.shape != x.shape:
        raise ValueError("x, score and centers must all be [m, d]")
    _check_blocks(block_i=block_i, block_j=block_j)
    if x.device.type == "cpu":
        return mpf_stream_step_plain(x, score, centers, bw, pbw, lr)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if any(t.dtype != torch.float32 or t.device != x.device
           for t in (score, centers)) or x.dtype != torch.float32:
        raise ValueError("x, score and centers must be float32 on one "
                         "device")
    from ._build import check, load_library

    def f(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=x.device).reshape(1)

    x = x.contiguous()
    score = score.contiguous()
    centers = centers.contiguous()
    scal = torch.cat([f(bw), f(pbw), f(lr)])
    x_new = torch.empty_like(x)
    gp_new = torch.empty_like(x)
    rc = load_library().dust_mpf_stream_step(
        x.data_ptr(), score.data_ptr(), centers.data_ptr(), scal.data_ptr(),
        x_new.data_ptr(), gp_new.data_ptr(), m, d,
        torch.cuda.current_stream(x.device).cuda_stream)
    fused_mpf_stream_step.launches += 1
    check(rc, "mpf_stream_step")
    return x_new, gp_new


fused_mpf_stream_step.launches = 0
