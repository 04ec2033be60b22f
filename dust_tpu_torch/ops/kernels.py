"""RBF kernel Gram matrices and their analytic gradients (counterpart of
`dust_tpu/ops/kernels.py`).

* `rbf_gram` / `rbf_gram_and_grad`: K = exp(-d^2 / (2 bw^2)), the gpytorch
  convention, with the gradient of sum(K) w.r.t. the first argument.
* `rbf_analytic`: K = exp(-d^2 / h), h a *squared* median-trick bandwidth,
  with closed-form dK/dX; batched over leading axes.
* `iid_mp`: `rbf_analytic` per (timestep, control-dim) slice.
"""

from __future__ import annotations

import math

import torch

from .distance import squared_distance


def rbf_gram(x, y, bw):
    """K = exp(-||x-y||^2 / (2 bw^2)) on row vectors."""
    return torch.exp(-squared_distance(x, y) / (bw**2) / 2.0)


def rbf_gram_and_grad(x, y, bw):
    """Gram matrix K [m, n] and the gradient of sum(K) w.r.t. x, [m, d]:
    dsum/dx_i = sum_j K_ij (y_j - x_i) / bw^2 (y held fixed)."""
    k = rbf_gram(x, y, bw)
    inv = 1.0 / (bw**2)
    grad = (k @ y - k.sum(dim=1, keepdim=True) * x) * inv
    return k, grad


def rbf_analytic(x, y, ell=-1.0, ell_scale=1.0, minimum_bw=1e-5):
    """Analytic RBF on x, y [..., m, d] (leading axes are independent
    slices). h is the lower median of d^2 per slice when ell < 0, else
    ell^2, then divided by log(m+1), scaled and clamped.
    Returns (K [..., m, m], dK/dX [..., m, m, d], h [...])."""
    pw = squared_distance(x, y)
    m = x.shape[-2]
    if ell < 0:
        flat = pw.flatten(-2)
        h = torch.sort(flat, dim=-1).values[..., (flat.shape[-1] - 1) // 2]
    else:
        h = torch.full(pw.shape[:-2], float(ell) ** 2, dtype=pw.dtype,
                       device=pw.device)
    h = h / math.log(m + 1.0)
    h = torch.clamp(ell_scale * h, min=minimum_bw)
    hb = h[..., None, None]
    k = torch.exp(-pw / hb)
    dk = (k.unsqueeze(-1) * (x.unsqueeze(-2) - y.unsqueeze(-3)) * 2.0
          / hb.unsqueeze(-1))
    return k, dk, h


def iid_mp(x, y, ctrl_dim, indep_controls=True, ell=-1.0, ell_scale=1.0,
           minimum_bw=1e-5):
    """Message-passing kernel: analytic RBF per timestep (and per control
    dim when `indep_controls`), stacked to [m, m, h*d].
    Returns (K [m, m, h*d], dK [m, m, h*d])."""
    m = x.shape[0]
    xs = x.reshape(m, -1, ctrl_dim)
    ys = y.reshape(m, -1, ctrl_dim)
    h = xs.shape[1]
    kw = dict(ell=ell, ell_scale=ell_scale, minimum_bw=minimum_bw)

    if indep_controls:
        xt = xs.reshape(m, h * ctrl_dim).T.unsqueeze(-1)   # [h*d, m, 1]
        yt = ys.reshape(m, h * ctrl_dim).T.unsqueeze(-1)
        k, dk, _ = rbf_analytic(xt, yt, **kw)              # [h*d, m, m(,1)]
        k = k.permute(1, 2, 0)                             # [m, m, h*d]
        dk = dk[..., 0].permute(1, 2, 0)
    else:
        xt = xs.permute(1, 0, 2)                           # [h, m, d]
        yt = ys.permute(1, 0, 2)
        k, dk, _ = rbf_analytic(xt, yt, **kw)              # [h, m, m(,d)]
        k = k.unsqueeze(-1).expand(h, m, m, ctrl_dim)      # [h, m, m, d]
        k = k.permute(1, 2, 0, 3).reshape(m, m, h * ctrl_dim)
        dk = dk.permute(1, 2, 0, 3).reshape(m, m, h * ctrl_dim)
    return k, dk
