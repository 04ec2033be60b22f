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
# the episode kernels' (K4/K5, K9/K10, K14, K15) register loop: a row per
# quad, each lane holding EPISODE_REGISTER_COLS columns or one fewer, so it
# serves EPISODE_REGISTER_MIN <= m_mpf <= EPISODE_REGISTER_MAX (49-52); the
# shared-memory walk every other size (csrc/pendulum_mpf.cuh and
# csrc/particle_mpf.cuh: kEpisodeRegCols)
EPISODE_REGISTER_COLS = 13
EPISODE_REGISTER_MAX = EPISODE_ROW_LANES * EPISODE_REGISTER_COLS
EPISODE_REGISTER_MIN = EPISODE_ROW_LANES * (EPISODE_REGISTER_COLS - 1) + 1
# the phases of K2 that its clocked build times, in order
# (csrc/pendulum_mpf.cuh, kClkLoad ... kClkStore); the two of an iteration
# are summed over the iterations
CLOCK_PHASES = ("load", "prior_score", "drive_update", "store")
# `with phase_clock() as rows:` launches K2's clocked build
phase_clock = PhaseClock(CLOCK_PHASES)


def episode_register_loop(m_mpf):
    """Whether an episode kernel's MPF update over m_mpf particles takes the
    register loop (`stein_loop_reg`, K15's `stein_loop_reg_nd`, K9/K10's
    `mass_stein_loop_reg`) rather than the shared-memory walk
    (`stein_loop`, `stein_loop_nd`, `mass_stein_loop`):
    csrc/pendulum_mpf.cuh:episode_stein_loop's rule, episode_stein_loop_nd's
    at three values a particle, and
    csrc/particle_mpf.cuh:episode_mass_stein_loop's at one."""
    return EPISODE_REGISTER_MIN <= m_mpf <= EPISODE_REGISTER_MAX


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


def _sq_dist(a, b):
    """The squared distances of columns a[e] [..., m, 1] to rows b[e]
    [..., 1, n], their D terms added in order, as the kernels add them."""
    d2 = (a[0] - b[0]) ** 2
    for e in range(1, len(a)):
        d2 = d2 + (a[e] - b[e]) ** 2
    return d2


def stein_loop_plain(x, prior_locs, bw, pbw, lr, lik, *, lanes, n_steps):
    """The MPF Stein loop over particles of D values as the kernels run it
    (`csrc/pendulum_mpf.cuh:stein_loop`, shared by K2, K4/K5 and K14 at
    D = 2; `stein_loop_nd`, K15's, at D = 3): x, prior_locs [..., m, D];
    bw, pbw, lr
    [..., 1, 1]; lik(x0, ..., x_{D-1}) -> (gl0, ..., gl_{D-1}), the
    likelihood gradient of the particles' columns [..., m, 1] (the loop's
    LikGrad). Returns the particles after n_steps updates. The sums over
    the particles and centers take the kernel's order (`lane_sum` over
    `lanes` lanes: ROW_LANES for K2, EPISODE_ROW_LANES for the episode
    kernels), a squared distance its D terms in order; its pairs' exps
    are one ex2.approx each, which agree with `torch.exp` here to ~1e-6
    relative."""
    D = x.shape[-1]
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    # center columns as rows
    ct = [prior_locs[..., :, e].unsqueeze(-2) for e in range(D)]
    xs = [x[..., :, e:e + 1] for e in range(D)]
    for _ in range(n_steps):
        gl = lik(*xs)
        # ---- GMM prior score over the fixed centers ----
        logits = -0.5 * _sq_dist(xs, ct) * inv_pbw2       # [..., m, m]
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, *pc = lane_sum(torch.stack([p, *(p * c for c in ct)]), lanes)
        gp = [(pc[e] / psum - xs[e]) * inv_pbw2 for e in range(D)]
        # ---- RBF Stein direction, repulsion folded into the drive ----
        tt = [((gl[e] + gp[e]) - xs[e] * inv_bw2).transpose(-1, -2)
              for e in range(D)]
        k = torch.exp(-0.5 * _sq_dist(xs, [v.transpose(-1, -2) for v in xs])
                      * inv_bw2)
        rows, *drive = lane_sum(torch.stack([k, *(k * t for t in tt)]),
                                lanes)
        xs = [xs[e] + lr * ((drive[e] + rows * xs[e] * inv_bw2) / m)
              for e in range(D)]
    return torch.cat(xs, dim=-1)


def pendulum_mpf_optimize_plain(x, prior_locs, scal, *, lanes, n_steps=20,
                                dt=0.05, g=9.8, log_space=False):
    """Plain PyTorch version of the kernel: x, prior_locs [..., m, 2];
    scal [..., 9] as built by `_scalars` (leading dims batch independent
    particle sets). Returns the particles after n_steps updates of
    `stein_loop_plain` under the pendulum's likelihood gradient (the
    kernels' `lik_grad`)."""
    bw, pbw, lr, sigma, theta0, theta_d0, action, loc0, loc1 = (
        v[..., None, None] for v in scal.unbind(-1))
    inv_s2 = 1.0 / (sigma * sigma)
    acts = torch.clamp(action, -_MAX_TORQUE, _MAX_TORQUE)
    sin_t = torch.sin(theta0 + math.pi)
    half3g = 3.0 * g * 0.5

    def lik(x0, x1):
        # ---- likelihood gradient (hand-derived pendulum physics) ----
        length, mass = x0, x1
        if log_space:
            length = torch.exp(length)
            mass = torch.exp(mass)
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
        return gl_l, gl_m

    return stein_loop_plain(x, prior_locs, bw, pbw, lr, lik, lanes=lanes,
                            n_steps=n_steps)


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
