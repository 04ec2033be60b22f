"""The whole pendulum MPF optimize loop in one launch (K2): counterpart of
`dust_tpu/ops/pallas_mpf.py`.

Each of the n_steps iterations computes the GMM prior score over the fixed
centers (isotropic `prior_bw`), the hand-derived Gaussian-likelihood
gradient through one pendulum step (with the speed-clip gate and the
log-space chain rule), the RBF Stein direction, and the SGD update.
Semantics = `MPF(reference_compat=False)`.

* On CUDA tensors `fused_pendulum_mpf_optimize` launches the hand-written
  kernel `csrc/pendulum_mpf.cu` (which replaces the TPU kernel
  `dust_tpu/ops/pallas_mpf.py:fused_pendulum_mpf_optimize`). It runs as
  one block with a group of `ROW_LANES` lanes per particle, so it takes at
  most `MAX_PARTICLES` particles; up to `REGISTER_MAX` particles each lane
  keeps its centers in registers. It is bound by the latency of its
  dependent iterations, not by bytes or arithmetic.
* On CPU tensors it runs `pendulum_mpf_optimize_plain`, the same
  arithmetic in plain PyTorch, operation by operation, its sums over j in
  the kernel's order (the kernel's pairs' exps are ex2.approx, ~1e-6
  relative from `torch.exp`).
"""

from __future__ import annotations

import math

import torch

from .particle_mpf import lane_sum
from .phase_clock import PhaseClock

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
# one CUDA block holds every particle
MAX_PARTICLES = 1024
# lanes per particle row in K2 (csrc/pendulum_mpf.cu:kLanes)
ROW_LANES = 8
# lanes per particle row in the episode kernels' MPF loop
# (csrc/pendulum_mpf.cuh:kRowLanes)
EPISODE_ROW_LANES = 4
# K2 keeps each lane's centers in registers up to this many particles
# (csrc/pendulum_mpf.cu:kRegMax)
REGISTER_MAX = 64
# the phases of K2 that its clocked build times, in order
# (csrc/pendulum_mpf.cuh, kClkLoad ... kClkStore); the two of an iteration
# are summed over the iterations
CLOCK_PHASES = ("load", "prior_score", "drive_update", "store")
# `with phase_clock() as rows:` launches K2's clocked build
phase_clock = PhaseClock(CLOCK_PHASES)


def _scalars(x, past_obs, loc, action, bw, prior_bw, lr, obs_sigma):
    """[bw, prior_bw, lr, sigma, theta0, theta_d0, action, loc0, loc1] as
    one float32 tensor on x's device (no host sync for device scalars)."""
    def f(v, n=1):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=x.device).reshape(n)

    return torch.cat([
        f(bw), f(prior_bw), f(lr), f(obs_sigma),
        f(past_obs, 2), f(action), f(loc, 2),
    ])


def pendulum_mpf_optimize_plain(x, prior_locs, scal, *, lanes, n_steps=20,
                                dt=0.05, g=9.8, log_space=False):
    """Plain PyTorch version of the kernel: x, prior_locs [..., m, 2];
    scal [..., 9] as built by `_scalars` (leading dims batch independent
    particle sets). Returns the particles after n_steps updates. The sums
    over the particles and centers take the kernel's order (`lane_sum`
    over `lanes` lanes: ROW_LANES for K2, EPISODE_ROW_LANES for the
    episode kernels); its pairs' exps are one ex2.approx each, which agree
    with `torch.exp` here to ~1e-6 relative."""
    bw, pbw, lr, sigma, theta0, theta_d0, action, loc0, loc1 = (
        v[..., None, None] for v in scal.unbind(-1))
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    inv_s2 = 1.0 / (sigma * sigma)
    acts = torch.clamp(action, -_MAX_TORQUE, _MAX_TORQUE)
    sin_t = torch.sin(theta0 + math.pi)
    half3g = 3.0 * g * 0.5
    c0t = prior_locs[..., :, 0].unsqueeze(-2)     # center columns as rows
    c1t = prior_locs[..., :, 1].unsqueeze(-2)
    x0 = x[..., :, 0:1]
    x1 = x[..., :, 1:2]
    for _ in range(n_steps):
        length, mass = x0, x1
        if log_space:
            length = torch.exp(length)
            mass = torch.exp(mass)
        # ---- likelihood gradient (hand-derived pendulum physics) ----
        il = 1.0 / length
        im = 1.0 / mass
        tdd = (-half3g) * il * sin_t + 3.0 * im * il * il * acts
        theta_d_raw = theta_d0 + dt * tdd
        theta_d = torch.clamp(theta_d_raw, -_MAX_SPEED, _MAX_SPEED)
        theta = theta0 + theta_d * dt
        gate = ((theta_d_raw > -_MAX_SPEED)
                & (theta_d_raw < _MAX_SPEED)).to(x.dtype)
        dtd_dl = gate * dt * (half3g * il * il * sin_t
                              - 6.0 * im * il * il * il * acts)
        dtd_dm = gate * dt * (-3.0 * im * im * il * il * acts)
        common = -((theta - loc0) * dt + (theta_d - loc1)) * inv_s2
        gl_l = common * dtd_dl
        gl_m = common * dtd_dm
        if log_space:
            gl_l = gl_l * length
            gl_m = gl_m * mass
        # ---- GMM prior score over the fixed centers ----
        d2c = (x0 - c0t) ** 2 + (x1 - c1t) ** 2    # [..., m, m]
        logits = -0.5 * d2c * inv_pbw2
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, pc0, pc1 = lane_sum(torch.stack([p, p * c0t, p * c1t]),
                                  lanes)
        gp0 = (pc0 / psum - x0) * inv_pbw2
        gp1 = (pc1 / psum - x1) * inv_pbw2
        # ---- RBF Stein direction, repulsion folded into the drive ----
        t0t = ((gl_l + gp0) - x0 * inv_bw2).transpose(-1, -2)
        t1t = ((gl_m + gp1) - x1 * inv_bw2).transpose(-1, -2)
        d2 = ((x0 - x0.transpose(-1, -2)) ** 2
              + (x1 - x1.transpose(-1, -2)) ** 2)
        k = torch.exp(-0.5 * d2 * inv_bw2)
        rows, drive0, drive1 = lane_sum(torch.stack([k, k * t0t, k * t1t]),
                                        lanes)
        phi0 = (drive0 + rows * x0 * inv_bw2) / m
        phi1 = (drive1 + rows * x1 * inv_bw2) / m
        x0 = x0 + lr * phi0
        x1 = x1 + lr * phi1
    return torch.cat([x0, x1], dim=-1)


def fused_pendulum_mpf_optimize(x, prior_locs, past_obs, loc, action, bw,
                                prior_bw, lr, obs_sigma, n_steps=20,
                                dt=0.05, g=9.8, log_space=False):
    """Run the whole MPF SVGD loop. x, prior_locs: [m, 2] (length, mass)
    particles / prior centers; past_obs [2] the prediction start, loc [2]
    the newest observation, action [1]; bw, prior_bw, lr, obs_sigma
    scalars (numbers or tensors). Returns x_final [m, 2].

    CPU tensors take the plain version (its sums in K2's order, ROW_LANES
    lanes per row); CUDA tensors launch the kernel (counted in
    `fused_pendulum_mpf_optimize.launches`)."""
    scal = _scalars(x, past_obs, loc, action, bw, prior_bw, lr, obs_sigma)
    if x.device.type == "cpu":
        return pendulum_mpf_optimize_plain(
            x, prior_locs, scal, n_steps=n_steps, dt=dt, g=g,
            log_space=log_space, lanes=ROW_LANES,
        )
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m = x.shape[0]
    if x.shape != (m, 2) or prior_locs.shape != (m, 2):
        raise ValueError("x and prior_locs must both be [m, 2]")
    if not 1 <= m <= MAX_PARTICLES:
        raise ValueError(
            f"fused pendulum MPF holds 1..{MAX_PARTICLES} particles in one "
            f"CUDA block, got m={m}"
        )
    if (x.dtype != torch.float32 or prior_locs.dtype != torch.float32
            or prior_locs.device != x.device):
        raise ValueError("x and prior_locs must be float32 on one device")
    from ._build import check, load_library

    x = x.contiguous()
    centers = prior_locs.contiguous()
    out = torch.empty_like(x)
    args = [x.data_ptr(), centers.data_ptr(), scal.data_ptr(),
            out.data_ptr(), m, int(n_steps), float(dt), 3.0 * g * 0.5,
            int(bool(log_space))]
    clock = phase_clock.rows(1, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if clock is None:
        rc = load_library().dust_pendulum_mpf_optimize(*args, stream)
    else:
        rc = load_library().dust_pendulum_mpf_optimize_clock(
            *args, clock.data_ptr(), stream)
    fused_pendulum_mpf_optimize.launches += 1
    check(rc, "pendulum_mpf_optimize")
    return out


fused_pendulum_mpf_optimize.launches = 0
