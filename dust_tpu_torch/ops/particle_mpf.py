"""The whole particle-mass MPF optimize loop in one launch (K7):
counterpart of `dust_tpu/ops/pallas_particle_mpf.py`.

Each of the n_steps SVGD iterations on m one-dimensional (log-)mass
particles computes the GMM prior score over the fixed centers (isotropic
`prior_bw`), the hand-derived gradient of the Gaussian observation
likelihood through one acceleration-control `Particle.step`, the RBF
Stein direction, and the SGD update. The mass enters the prediction only
through the velocity,

    v_pred_j = clip(v0_j + clip(a_j / m, +-max_acc) * scale, +-max_speed),

with scale = dt * (1 - collision at the prediction start) computed by the
caller, so the gradient needs only the velocity components; both clips
pass the gradient on their strict interior only. Semantics =
`MPF(reference_compat=False)`.

* On CUDA tensors `fused_particle_mpf_optimize` launches the hand-written
  kernel `csrc/particle_mpf.cu` (which replaces the TPU kernel
  `dust_tpu/ops/pallas_particle_mpf.py:fused_particle_mpf_optimize`): one
  block, a quad of lanes per particle (`ROW_LANES`), each lane's centers
  in registers up to `REGISTER_MAX` particles and K9/K10's shared-memory
  loop above; bound by the latency of its dependent iterations. Its scalars reach it as kernel arguments
  (`scalar_sources`), so a call launches the kernel and nothing else.
* On CPU tensors it runs `particle_mpf_optimize_plain`, the same
  arithmetic in plain PyTorch, its sums over j in the kernel's order.
"""

from __future__ import annotations

import ctypes

import torch

from .phase_clock import PhaseClock

# one CUDA block holds every particle
MAX_PARTICLES = 1024
# lanes per particle row in K7 and K9/K10 (csrc/particle_mpf.cuh:kRowLanes)
ROW_LANES = 4
# K7 keeps each lane's centers in registers up to this many particles
# (csrc/particle_mpf.cu:kRegMax)
REGISTER_MAX = 64
# the phases of K7 that its clocked build times, in order
# (csrc/particle_mpf.cuh, kMpfClkLoad ... kMpfClkStore); the two of an
# iteration are summed over the iterations
CLOCK_PHASES = ("load", "prior_score", "drive_update", "store")
# `with phase_clock() as rows:` launches K7's clocked build (m <=
# REGISTER_MAX; it refuses larger m)
phase_clock = PhaseClock(CLOCK_PHASES)



def mpf_scalars(x, past_obs, loc, action, scale, bw, prior_bw, lr,
                obs_sigma):
    """[bw, prior_bw, lr, sigma, v0x, v0y, ax, ay, loc_vx, loc_vy, scale]
    as one float32 tensor on x's device (no host sync for device
    scalars)."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=x.device).reshape(-1)

    return torch.cat([
        f(bw), f(prior_bw), f(lr), f(obs_sigma), f(past_obs)[2:4],
        f(action)[:2], f(loc)[2:4], f(scale),
    ])


def scalar_sources(x, past_obs, loc, action, scale, bw, prior_bw, lr,
                   obs_sigma):
    """The scalars of `mpf_scalars`, in its order, as K7 takes them
    (csrc/particle_mpf.cu:MassScalars), without a launch: (ptrs, vals,
    keep). For a float32 tensor on x's device ptrs holds the address of
    the element and the kernel reads it there; for a Python number or a
    tensor on the CPU, ptr 0 and the value in vals (read on the host, no
    sync). A tensor of another type or device is converted first, and
    `keep` holds the converted copies until the launch is queued."""
    ptrs, vals, keep = [], [], []

    def add(v, elems):
        if not torch.is_tensor(v):
            for _ in elems:
                ptrs.append(0)
                vals.append(float(v))
            return
        if v.device.type == "cpu" and x.device.type != "cpu":
            flat = v.detach().reshape(-1)
            for e in elems:
                ptrs.append(0)
                vals.append(float(flat[e]))
            return
        if (v.dtype != torch.float32 or v.device != x.device
                or not v.is_contiguous()):
            v = v.to(device=x.device, dtype=torch.float32).contiguous()
            keep.append(v)
        for e in elems:
            ptrs.append(v.data_ptr() + 4 * e)
            vals.append(0.0)

    for v, elems in ((bw, (0,)), (prior_bw, (0,)), (lr, (0,)),
                     (obs_sigma, (0,)), (past_obs, (2, 3)), (action, (0, 1)),
                     (loc, (2, 3)), (scale, (0,))):
        add(v, elems)
    return ptrs, vals, keep


def _vel_grad_term(a, v0, loc, invm, scale, inv_s2, max_acc, max_speed):
    """-(pred - loc) / sigma^2 * dpred/dm for one velocity component."""
    acc_raw = a * invm
    acc = torch.clamp(acc_raw, -max_acc, max_acc)
    g_a = ((acc_raw > -max_acc) & (acc_raw < max_acc)).to(invm.dtype)
    v_raw = v0 + acc * scale
    pred = torch.clamp(v_raw, -max_speed, max_speed)
    g_v = ((v_raw > -max_speed) & (v_raw < max_speed)).to(invm.dtype)
    dpred = g_v * g_a * (-a * invm * invm) * scale
    return -(pred - loc) * inv_s2 * dpred


def lane_sum(t, lanes):
    """Sums t over its last axis (j) as a group of `lanes` lanes of a
    kernel does it (csrc/stein.cuh:lane_group_sum): lane l adds the terms
    j = l, l + lanes, ... in order, starting from 0, then neighbouring
    lanes' partial sums meet pairwise, for 4 lanes (p0 + p1) + (p2 + p3).
    Keeps the axis."""
    t = torch.nn.functional.pad(t, (0, -t.shape[-1] % lanes))
    t = t.reshape(*t.shape[:-1], -1, lanes)
    acc = torch.zeros_like(t[..., 0, :])
    for s in range(t.shape[-2]):
        acc = acc + t[..., s, :]
    while acc.shape[-1] > 1:
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc


def particle_mpf_optimize_plain(x, prior_locs, scal, n_steps=20,
                                max_acc=10.0, max_speed=5.0, log_space=True):
    """Plain PyTorch version of the kernel: x, prior_locs [..., m, 1];
    scal [..., 11] as built by `mpf_scalars` (leading dims batch
    independent particle sets). Returns the particles after n_steps
    updates. The sums over the particles and centers take the kernel's
    order (`lane_sum` over ROW_LANES lanes); its exps are one ex2.approx
    each, which agree with `torch.exp` here to ~1e-6 relative."""
    bw, pbw, lr, sigma, v0x, v0y, ax, ay, loc_vx, loc_vy, scale = (
        v[..., None, None] for v in scal.unbind(-1))
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    inv_s2 = 1.0 / (sigma * sigma)
    c0t = prior_locs.transpose(-1, -2)            # centers as a row
    x0 = x
    for _ in range(n_steps):
        mass = torch.exp(x0) if log_space else x0
        invm = 1.0 / mass
        # ---- likelihood gradient (hand-derived particle physics) ----
        gl = (_vel_grad_term(ax, v0x, loc_vx, invm, scale, inv_s2, max_acc,
                             max_speed)
              + _vel_grad_term(ay, v0y, loc_vy, invm, scale, inv_s2,
                               max_acc, max_speed))
        if log_space:
            gl = gl * mass
        x0t = x0.transpose(-1, -2)
        # ---- GMM prior score over the fixed centers ----
        logits = -0.5 * (x0 - c0t) ** 2 * inv_pbw2
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, pc = lane_sum(torch.stack([p, p * c0t]), ROW_LANES)
        s0 = gl + (pc / psum - x0) * inv_pbw2
        # ---- RBF Stein direction, repulsion folded into the drive ----
        k = torch.exp(-0.5 * (x0 - x0t) ** 2 * inv_bw2)
        t0t = s0.transpose(-1, -2) - x0t * inv_bw2
        rows, drive0 = lane_sum(torch.stack([k, k * t0t]), ROW_LANES)
        phi0 = (drive0 + rows * x0 * inv_bw2) / float(m)
        x0 = x0 + lr * phi0
    return x0


def fused_particle_mpf_optimize(x, prior_locs, past_obs, loc, action, scale,
                                bw, prior_bw, lr, obs_sigma, n_steps=20,
                                max_acc=10.0, max_speed=5.0, log_space=True):
    """Run the whole particle-mass MPF SVGD loop. x, prior_locs: [m, 1]
    (log-)mass particles / prior centers; past_obs [4] the prediction
    start, loc [4] the newest observation, action [2], scale = dt * (1 -
    collision(past_obs)); bw, prior_bw, lr, obs_sigma scalars (numbers or
    tensors). Returns x_final [m, 1].

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and nothing else (counted in `fused_particle_mpf_optimize.launches`)."""
    if x.device.type == "cpu":
        scal = mpf_scalars(x, past_obs, loc, action, scale, bw, prior_bw, lr,
                           obs_sigma)
        return particle_mpf_optimize_plain(
            x, prior_locs, scal, n_steps=n_steps, max_acc=max_acc,
            max_speed=max_speed, log_space=log_space)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m = x.shape[0]
    if x.shape != (m, 1) or prior_locs.shape != (m, 1):
        raise ValueError("x and prior_locs must both be [m, 1]")
    if not 1 <= m <= MAX_PARTICLES:
        raise ValueError(
            f"fused particle MPF holds 1..{MAX_PARTICLES} particles in one "
            f"CUDA block, got m={m}"
        )
    if (x.dtype != torch.float32 or prior_locs.dtype != torch.float32
            or prior_locs.device != x.device):
        raise ValueError("x and prior_locs must be float32 on one device")
    from ._build import check, load_library

    x = x.contiguous()
    centers = prior_locs.contiguous()
    out = torch.empty_like(x)
    ptrs, vals, keep = scalar_sources(x, past_obs, loc, action, scale, bw,
                                      prior_bw, lr, obs_sigma)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_vals = (ctypes.c_float * len(vals))(*vals)
    args = [x.data_ptr(), centers.data_ptr(), ctypes.addressof(c_ptrs),
            ctypes.addressof(c_vals), out.data_ptr(), m, int(n_steps),
            float(max_acc), float(max_speed), int(bool(log_space))]
    clock = phase_clock.rows(1, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if clock is None:
        rc = load_library().dust_particle_mpf_optimize(*args, stream)
    else:
        rc = load_library().dust_particle_mpf_optimize_clock(
            *args, clock.data_ptr(), stream)
    del keep  # the launch is queued: the converted copies may go
    fused_particle_mpf_optimize.launches += 1
    check(rc, "particle_mpf_optimize")
    return out


fused_particle_mpf_optimize.launches = 0
