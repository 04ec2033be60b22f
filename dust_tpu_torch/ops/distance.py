"""Pairwise squared distances (counterpart of `dust_tpu/ops/distance.py`)."""

from __future__ import annotations

import torch


def squared_distance(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between the rows of x1 [..., m, d] and
    x2 [..., n, d] -> [..., m, n], clamped at zero.

    Both operands are shifted by the (detached) mean of x1 first: the
    distances are translation invariant but the Gram identity's
    cancellation error grows with ||x||^2."""
    mu = x1.mean(dim=-2, keepdim=True).detach()
    x1 = x1 - mu
    x2 = x2 - mu
    x1_norm = (x1 * x1).sum(-1, keepdim=True)          # [..., m, 1]
    x2_norm = (x2 * x2).sum(-1, keepdim=True)          # [..., n, 1]
    cross = x1 @ x2.transpose(-1, -2)
    res = x1_norm + x2_norm.transpose(-1, -2) - 2.0 * cross
    return torch.clamp(res, min=0.0)
