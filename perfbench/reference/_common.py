"""Plain PyTorch pieces that both tasks' references share.

Nothing here imports the program. The sweep references repeat the
arithmetic of the episode kernels' plain versions (the counter-based
noise, the Silverman bandwidths, the DISCO weights, the Stein step and
forward, sums in a kernel's lane order), written against the algorithm's
published semantics, so they read the same draws as the kernels and
agree with them to rounding. Every function computes in the floating
type of its inputs, so the same code run on bfloat16 inputs is the
lower-precision control.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
# KDEpy's exact IQR normalizer; statsmodels rounds it to 1.349
IQR_NORM_EXACT = 1.3489795003921634
IQR_NORM_REF = 1.349


# -- the counter-based noise of the sweeps ------------------------------------


def _mul32(x, c):
    """(x * c) mod 2^32 for x < 2^32 in int64, in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash32(x):
    """lowbias32: xor-shift, multiply, twice."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def rng_key(seed0, seed1, step, scenario):
    """The key of one (episode, step): int64 tensors -> int64 < 2^32."""
    k = hash32((seed0.to(torch.int64) + 0x9E3779B9) & MASK32)
    k = hash32(k ^ (seed1.to(torch.int64) & MASK32))
    k = hash32(k ^ step)
    return hash32(k ^ (scenario.to(torch.int64) & MASK32))


def counter_bits(key, idx):
    return hash32((hash32(idx ^ key) + key) & MASK32)


def bits_to_uniform(bits):
    """U[0, 1) from the top 23 bits, on the exponent of 1.0 (float32)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def normals_at(key, n_idx):
    """Box-Muller normals for normal indices n_idx (float32)."""
    u1 = bits_to_uniform(counter_bits(key, 2 * n_idx)) + (2.0 ** -24)
    u2 = bits_to_uniform(counter_bits(key, 2 * n_idx + 1))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


# -- bandwidths --------------------------------------------------------------------


def percentile_plan(n, q):
    """Linear-interpolation percentile q of n sorted values: 0-based
    indices (lo, hi) and the fraction."""
    pos = q / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    return lo, min(lo + 1, n - 1), pos - lo


def silverman_rows(v):
    """KDEpy's Silverman bandwidth of every row of v [B, n]: sigma =
    min(std (ddof 1), IQR / 1.34898), the IQR only where it is positive;
    bw = max(sigma * (3n/4)^(-1/5), 1e-6). Moments from the sums of the
    values and their squares, percentiles from the sorted row."""
    n = v.shape[-1]
    s1 = v.sum(dim=-1)
    s2 = (v * v).sum(dim=-1)
    mean = s1 / float(n)
    var = (s2 - float(n) * mean * mean) / float(n - 1)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    srt = torch.sort(v, dim=-1).values
    lo25, hi25, f25 = percentile_plan(n, 25.0)
    lo75, hi75, f75 = percentile_plan(n, 75.0)
    q25 = srt[..., lo25] * (1.0 - f25) + srt[..., hi25] * f25
    q75 = srt[..., lo75] * (1.0 - f75) + srt[..., hi75] * f75
    iqr = (q75 - q25) * (1.0 / IQR_NORM_EXACT)
    sigma = torch.where(iqr > 0, torch.minimum(std, iqr), std)
    return torch.clamp(sigma * (n * 3.0 / 4.0) ** (-0.2), min=1e-6)


def quantile(srt, q):
    """Percentile q of sorted values srt [n] by linear interpolation
    between the neighbouring order statistics (`torch.lerp`, whose
    rounding torch.quantile shares)."""
    lo, hi, frac = percentile_plan(srt.shape[0], q)
    return torch.lerp(srt[lo], srt[hi],
                      torch.tensor(frac, dtype=srt.dtype, device=srt.device))


def silverman_statsmodels(x):
    """statsmodels' rule on particles x [n, d]: 0.9 * A * n^(-1/5), A the
    IQR / 1.349 of all values where it is positive and below every
    column's std, else the per-column std (ddof 1) - a vector then."""
    srt = torch.sort(x.reshape(-1)).values
    iqr = (quantile(srt, 75.0) - quantile(srt, 25.0)) / IQR_NORM_REF
    std = torch.std(x, dim=0, correction=1)
    a = torch.where((iqr > 0) & (iqr < std.min()), iqr, std)
    return 0.9 * a * x.shape[0] ** (-0.2)


# -- sums in a kernel's lane order ---------------------------------------------


def lane_sum(t, lanes):
    """Sum over the last axis as a group of `lanes` kernel lanes does it:
    lane l adds terms l, l + lanes, ... in order from 0, then neighbouring
    lanes' partial sums meet pairwise. Keeps the axis."""
    t = torch.nn.functional.pad(t, (0, -t.shape[-1] % lanes))
    t = t.reshape(*t.shape[:-1], -1, lanes)
    acc = torch.zeros_like(t[..., 0, :])
    for s in range(t.shape[-2]):
        acc = acc + t[..., s, :]
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc


# -- DISCO weights and the Stein step of the sweeps ----------------------------


def disco_weights(mcost, inv_temp, alpha, exp_util):
    """DISCO's softmax over the samples (shifted by the global least
    cost), the likelihood's per-particle softmax and log-likelihood.
    mcost [B, m, n_act] -> (omega, eta [B, m, 1], w_lik, log_l
    [B, m, 1])."""
    n_act = mcost.shape[-1]
    beta = mcost.amin(dim=(-2, -1), keepdim=True)
    lc = -(mcost - beta) * inv_temp
    row_max = lc.amax(dim=-1, keepdim=True)
    e = torch.exp(lc - row_max)
    sum_e = e.sum(dim=-1, keepdim=True)
    eta = row_max + torch.log(sum_e)
    omega = e / sum_e
    wl = -mcost * alpha
    wl_max = wl.amax(dim=-1, keepdim=True)
    we = torch.exp(wl - wl_max)
    we_sum = we.sum(dim=-1, keepdim=True)
    w_lik = we / we_sum
    if exp_util:
        log_l = wl_max + torch.log(we_sum) - math.log(float(n_act))
    else:
        log_l = -alpha * mcost.sum(dim=-1, keepdim=True) * (1.0 / n_act)
    return omega, eta, w_lik, log_l


def _prior_logits(theta, locs, log_mix, neg_half_ips2):
    """[B, m, m] component log-probs of an isotropic GMM (+ the mixture
    log-weights), the squared distances summed over the row."""
    m = theta.shape[1]
    cols = []
    for c in range(m):
        diff = theta - locs[:, c:c + 1]
        lm = log_mix if log_mix.ndim < 2 else log_mix[:, c:c + 1, None]
        d2 = (diff * diff).sum(dim=-1, keepdim=True)
        cols.append(neg_half_ips2 * d2 + lm)
    return torch.cat(cols, dim=-1)


def stein_forward(theta, locs, glik, log_mix, bw, lr, inv_ps2, log_l,
                  dim_a=1):
    """The Stein direction under the RBF kernel and an SGD step, then the
    forward pass: posterior weights, the first argmax's plan, the plans
    rolled by one step with the last repeated. theta / locs / glik
    [B, m, hz * dim_a]; log_mix a scalar or [B, m]; bw [B]; log_l
    [B, m, 1]. Returns (theta_new, theta_fwd, weights [B, m], a_sel
    [B, hz * dim_a])."""
    m = theta.shape[1]
    bw = bw.reshape(-1, 1, 1)
    inv_bw2 = 1.0 / (bw * bw)
    inv_2bw2 = 0.5 * inv_bw2
    neg_half_ips2 = -0.5 * inv_ps2

    lp_pri = _prior_logits(theta, locs, log_mix, neg_half_ips2)
    r_e = torch.exp(lp_pri - lp_pri.amax(dim=-1, keepdim=True))
    r = r_e / r_e.sum(dim=-1, keepdim=True)
    score = glik
    for c in range(m):
        score = score + r[:, :, c:c + 1] * (locs[:, c:c + 1] - theta) \
            * inv_ps2

    kcols = []
    for c in range(m):
        diff = theta - theta[:, c:c + 1]
        kcols.append(torch.exp(-inv_2bw2 * (diff * diff).sum(
            dim=-1, keepdim=True)))
    kmat = torch.cat(kcols, dim=-1)
    k_score = torch.zeros_like(theta)
    k_theta = torch.zeros_like(theta)
    for c in range(m):
        k_score = k_score + kmat[:, :, c:c + 1] * score[:, c:c + 1]
        k_theta = k_theta + kmat[:, :, c:c + 1] * theta[:, c:c + 1]
    rowsum_k = kmat.sum(dim=-1, keepdim=True)
    grad_k = -(k_theta - rowsum_k * theta) * inv_bw2
    phi = (k_score + grad_k) * (1.0 / m)
    theta_new = theta + lr * phi

    lp_new = _prior_logits(theta_new, locs, log_mix, neg_half_ips2)
    n_max = lp_new.amax(dim=-1, keepdim=True)
    log_p = n_max + torch.log(torch.exp(lp_new - n_max).sum(
        dim=-1, keepdim=True))
    log_w = (log_l + log_p)[..., 0]
    w_max = log_w.amax(dim=-1, keepdim=True)
    w_e = torch.exp(log_w - w_max)
    weights = w_e / w_e.sum(dim=-1, keepdim=True)
    rows = torch.arange(m, device=theta.device)
    i_star = torch.where(log_w >= w_max, rows, m).amin(dim=-1)
    a_sel = torch.where(
        (i_star < m)[:, None],
        theta_new[torch.arange(theta.shape[0], device=theta.device),
                  i_star.clamp(max=m - 1)],
        torch.zeros((), dtype=theta.dtype, device=theta.device))
    theta_fwd = torch.cat([theta_new[..., dim_a:], theta_new[..., -dim_a:]],
                          dim=-1)
    return theta_new, theta_fwd, weights, a_sel


def chain_seeds(seeds, n_chains):
    """seeds [G, 2] -> [G, n_chains, 2] int64: chain c adds 4099 * c to
    the second word (the sweeps' documented chain-seed stride)."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64)
    stride = torch.tensor([0, 4099], dtype=torch.int64, device=seeds.device)
    return torch.stack([seeds + stride * c for c in range(n_chains)], dim=1)

