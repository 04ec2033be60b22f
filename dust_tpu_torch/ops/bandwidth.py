"""Kernel bandwidth heuristics (counterpart of `dust_tpu/ops/bandwidth.py`).

* `bw_median`      — median trick
* `bw_silverman`   — statsmodels-style 0.9 * A * n^(-1/5); a vector when
                     the per-column std wins over the IQR
* `silvermans_rule` — KDEpy convention on the flattened particles

Percentiles are linear interpolation (`jnp.percentile`'s default), stds use
ddof=1. Everything stays on the input's device (no host sync).
"""

from __future__ import annotations

import torch

from .distance import squared_distance

# norm.ppf(0.75) - norm.ppf(0.25): the statsmodels-style rule uses the
# rounded 1.349, KDEpy the exact value.
_IQR_NORMALIZE_REF = 1.349
_IQR_NORMALIZE_EXACT = 1.3489795003921634


def _percentiles(flat, qs):
    q = torch.tensor([p / 100.0 for p in qs], dtype=flat.dtype,
                     device=flat.device)
    return torch.quantile(flat, q, interpolation="linear")


def median_lower(x):
    """torch.median convention: the lower of the two middle order
    statistics for even-length inputs."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    return torch.sort(flat).values[(n - 1) // 2]


def select_sigma(x, percentile: int = 25):
    """Smaller of the per-column std (ddof=1) and the normalized IQR of the
    flattened input; a vector over columns either way."""
    flat = x.reshape(-1)
    hi, lo = _percentiles(flat, (100 - percentile, percentile))
    iqr = (hi - lo) / _IQR_NORMALIZE_REF
    std_dev = torch.std(x, dim=0, correction=1)
    use_iqr = (iqr > 0) & (iqr < std_dev.min())
    return torch.where(use_iqr, iqr, std_dev)


def bw_median(x, y=None, bw_scale: float = 1.0, tol: float = 1.0e-5):
    """bw = sqrt(0.5 * median(d^2)) / log(m + 1), clamped at `tol`."""
    if y is None:
        y = x
    h = median_lower(squared_distance(x, y))
    h = torch.sqrt(0.5 * h) / torch.log(
        torch.tensor(x.shape[0] + 1.0, device=x.device)
    )
    return bw_scale * torch.clamp(h, min=tol)


def bw_silverman(x, bw_scale: float = 1.0):
    """0.9 * min(std, IQR/1.349) * n^(-1/5), n the number of rows."""
    a = select_sigma(x)
    n = x.shape[0]
    return bw_scale * 0.9 * a * n ** (-0.2)


def silvermans_rule(x):
    """KDEpy-convention Silverman rule on the flattened data:
    sigma = min(std_ddof1, IQR/1.34898), bw = sigma * (3n/4)^(-1/5),
    floored at 1e-6 for collapsed particle sets."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    sigma = torch.std(flat, correction=1)
    hi, lo = _percentiles(flat, (75, 25))
    iqr = (hi - lo) / _IQR_NORMALIZE_EXACT
    sigma = torch.where(iqr > 0, torch.minimum(sigma, iqr), sigma)
    return torch.clamp(sigma * (n * 3.0 / 4.0) ** (-0.2), min=1e-6)
