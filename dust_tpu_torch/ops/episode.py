"""The whole pendulum DuSt episode in one launch (K4): counterpart of
`dust_tpu/ops/pallas_episode.py`, with its shared helpers.

`steps` iterations of

  SVMPC solve (action noise, dynamics-parameter draws from the live MPF
  prior, all n_params x m x n_act rollouts and costs, DISCO update, Stein
  step, selection, roll) -> simulator step (gym `Pendulum-v0` physics with
  the episode's true parameters, g_sim) -> MPF update (Silverman
  bandwidth, `mpf_steps` Stein iterations, prior refresh)

run as one program; nothing returns to the host until the episode ends.
Each step's log holds (th, om, action, cost, bw_sv, bw_mpf).

Noise has two modes:

* host-noise mode (the parity path): `host_eps [steps, hz, 8, 128]`,
  `host_pdz [steps, 8, 128]` and `host_pdu [steps, 8, 128]` in the JAX
  layout, so both packages are fed the same draws;
* device-RNG mode: a counter-based generator (`counter_bits`, lowbias32
  hashes keyed by (seed[0], seed[1], step, scenario, draw index)) with
  Box-Muller normals, as `_normals`/`_uniform01` build them from bits.
  The TPU's hardware PRNG has no counterpart, so this stream equals the
  TPU one in distribution only; the plain version reproduces it exactly
  (integer hashes on int64 tensors masked to 32 bits).

* On CUDA tensors `fused_pendulum_episode` launches the hand-written
  kernel `csrc/pendulum_episode.cu` (which replaces the TPU kernel
  `dust_tpu/ops/pallas_episode.py:fused_pendulum_episode`): a cluster of
  four blocks runs the whole episode, sharing out the noise and the
  rollouts; the solve, the simulator and the MPF loop (K2's device code)
  follow each other inside it (the launch: `PENDULUM` on
  `ops/episode_kernel.py:run_episodes`). A sweep (`ops/sweep_episode.py`)
  runs one block per episode with the same bits.
* On CPU tensors it runs `pendulum_episode_plain`, the same arithmetic in
  plain PyTorch, batched over episodes (the sweep, `ops/sweep_episode.py`,
  shares it).
"""

from __future__ import annotations

import math

import torch

from .episode_kernel import (
    EpisodeKernel,
    mpf_scalars,
    run_episodes,
    split_log,
)
from .phase_clock import PhaseClock

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
_SWINGUP_W = 50.0
# KDEpy's exact IQR normalizer (ops/bandwidth.py:_IQR_NORMALIZE_EXACT)
_IQR_NORM = 1.3489795003921634
_MASK32 = 0xFFFFFFFF
LOG_FIELDS = ("th", "om", "action", "cost", "bw_sv", "bw_mpf")
# the phases of one step that the kernel's clocked build times, in order
# (csrc/pendulum_episode.cu, kClkNoise ... kClkLog)
CLOCK_PHASES = ("noise", "silverman", "draws", "rollouts", "disco_weights",
                "disco_delta", "stein_forward", "commit_simulator",
                "mpf_bandwidth", "mpf_loop", "log")
# `with phase_clock() as rows:` launches the clocked build
phase_clock = PhaseClock(CLOCK_PHASES)
# lanes that share one entry's sum over the action samples in the kernel's
# DISCO delta (csrc/pendulum_episode.cu:kSumLanes)
SUM_LANES = 8


# -- shared helpers -----------------------------------------------------------


def rot_sincos(x, xmax):
    """sin/cos of the per-rollout-step rotation angle x = om * dt, with
    |x| <= xmax: short Taylor polynomials below float32 rounding for
    xmax <= 1, exact trig above (`pallas_episode.py:_rot_sincos`)."""
    if xmax > 1.0:
        return torch.sin(x), torch.cos(x)
    x2 = x * x
    if xmax <= 0.5:
        s = x * (1.0 + x2 * (-1.0 / 6.0
                             + x2 * (1.0 / 120.0 - x2 * (1.0 / 5040.0))))
        c = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24.0 - x2 * (1.0 / 720.0)))
    else:
        s = x * (1.0 + x2 * (-1.0 / 6.0 + x2 * (
            1.0 / 120.0 + x2 * (-1.0 / 5040.0 + x2 * (1.0 / 362880.0)))))
        c = 1.0 + x2 * (-0.5 + x2 * (1.0 / 24.0 + x2 * (
            -1.0 / 720.0 + x2 * (1.0 / 40320.0))))
    return s, c


def percentile_ks(n, q):
    """Linear-interpolation plan for percentile q of n values: 1-indexed
    order statistics (k_lo, k_hi) and the fraction."""
    pos = q / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    frac = pos - lo
    return lo + 1, min(lo + 2, n), frac


def silverman_rows(v):
    """KDEpy-convention Silverman bandwidth of every row of v [B, n], from
    exact order statistics (`pallas_episode.py:_silverman_row`):
    sigma = min(std_ddof1, IQR/1.34898) (the IQR only if > 0),
    bw = max(sigma * (3n/4)^(-1/5), 1e-6). Equals
    `ops.bandwidth.silvermans_rule` of each row, duplicates included.
    Returns [B]."""
    n = v.shape[-1]
    s1 = v.sum(dim=-1)
    s2 = (v * v).sum(dim=-1)
    mean = s1 / float(n)
    var = (s2 - float(n) * mean * mean) / float(n - 1)
    std = torch.sqrt(torch.clamp(var, min=0.0))
    srt = torch.sort(v, dim=-1).values
    k25lo, k25hi, f25 = percentile_ks(n, 25.0)
    k75lo, k75hi, f75 = percentile_ks(n, 75.0)
    q25 = srt[..., k25lo - 1] * (1.0 - f25) + srt[..., k25hi - 1] * f25
    q75 = srt[..., k75lo - 1] * (1.0 - f75) + srt[..., k75hi - 1] * f75
    iqr = (q75 - q25) * (1.0 / _IQR_NORM)
    sigma = torch.where(iqr > 0, torch.minimum(std, iqr), std)
    return torch.clamp(sigma * (n * 3.0 / 4.0) ** (-0.2), min=1e-6)


# -- counter-based noise --------------------------------------------------------


def _mul32(x, c):
    """(x * c) mod 2^32 for x < 2^32 in int64, in 16-bit halves (no int64
    overflow)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x):
    """lowbias32: a bijective 32-bit integer hash (xor-shift, multiply)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def rng_key(seed0, seed1, step, scenario):
    """The per-(episode, step) key: int64 tensors (or ints) of any
    broadcastable shapes -> int64 key < 2^32."""
    k = _hash32((torch.as_tensor(seed0, dtype=torch.int64) + 0x9E3779B9)
                & _MASK32)
    k = _hash32(k ^ (torch.as_tensor(seed1, dtype=torch.int64) & _MASK32))
    k = _hash32(k ^ step)
    return _hash32(k ^ (torch.as_tensor(scenario, dtype=torch.int64)
                        & _MASK32))


def counter_bits(key, idx):
    """32 random bits for draw `idx` under `key` (int64 tensors)."""
    return _hash32((_hash32(idx ^ key) + key) & _MASK32)


def bits_to_uniform(bits):
    """u ~ U[0, 1): 23 random mantissa bits on the exponent of 1.0, minus
    1 (`pallas_episode.py:_uniform01`)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fb.view(torch.float32) - 1.0


def _normals_at(key, n_idx):
    """Box-Muller normals for normal indices n_idx (uniforms 2n, 2n+1)."""
    u1 = bits_to_uniform(counter_bits(key, 2 * n_idx)) + (2.0 ** -24)
    u2 = bits_to_uniform(counter_bits(key, 2 * n_idx + 1))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def device_noise(seeds, scenario, step, hz, m, n_act, n_params):
    """One step's draws of the device-RNG mode. seeds [B, 2], scenario [B]
    (int64 tensors). Draw indices per (episode, step): action normals
    (t*m + q)*n_act + i, then parameter normals n_eps + 2p + j, then
    component uniforms at uniform index 2*(n_eps + 2*n_params) + p.
    Returns eps [B, hz, m, n_act], pdz [B, n_params, 2], pdu
    [B, n_params]."""
    dev = seeds.device
    key = rng_key(seeds[:, 0], seeds[:, 1], step, scenario)
    n_eps = hz * m * n_act
    kb = key.reshape(-1, 1)
    eps = _normals_at(kb, torch.arange(n_eps, device=dev)).reshape(
        -1, hz, m, n_act)
    pdz = _normals_at(kb, n_eps + torch.arange(2 * n_params, device=dev))
    pdu = bits_to_uniform(counter_bits(
        kb, 2 * (n_eps + 2 * n_params) + torch.arange(n_params, device=dev)))
    return eps, pdz.reshape(-1, n_params, 2), pdu


# -- the episode, batched -----------------------------------------------------


def episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma, mpf_lr,
                 mpf_sigma, prior_bw0, m, device):
    """[th0, om0, ctrl_sigma, lr, alpha, inv_temp, inv_s2, inv_ps2, mpf_lr,
    mpf_sigma, prior_bw0, log_mix] as one float32 tensor on `device`
    (no host sync for device scalars)."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).reshape(-1)

    return torch.cat([
        f(state0)[:2], f(ctrl_sigma), f(lr), f(alpha), 1.0 / f(temp),
        1.0 / f(ctrl_sigma) ** 2, 1.0 / f(prior_sigma) ** 2, f(mpf_lr),
        f(mpf_sigma), f(prior_bw0), f(-math.log(m)),
    ])


def pendulum_episode_plain(scal, ep_f, seeds, scenario, theta0, locs0, amat0,
                           a_seq, mpfx0, eps=None, pdz=None, pdu=None, *,
                           steps, warm_up, n_params, n_act, mpf_steps, dt,
                           g_model, g_sim, exp_util, mpf_log_space,
                           mpf_fixed_bw, mpf_bw_scale):
    """Plain PyTorch version of the kernel over B independent episodes.

    scal [12] as built by `episode_scal`; ep_f [B, 2] (1/true length,
    1/true mass); seeds [B, 2], scenario [B] int64 (device-RNG mode);
    theta0/locs0/amat0 [B, m, hz]; a_seq [hz] or None (no a_seq term);
    mpfx0 [B, m_mpf, 2]. Host-noise mode passes eps [B, steps, hz, m,
    n_act], pdz [B, steps, n_params, 2], pdu [B, steps, n_params].
    Returns (log [B, steps, 6], theta, locs, a_mat [B, m, hz],
    mpf_x [B, m_mpf, 2])."""
    from .mpf import EPISODE_ROW_LANES, pendulum_mpf_optimize_plain
    from .particle_mpf import lane_sum
    from .solve import disco_weights, rollout_mcost, stein_forward

    (th0, om0, sigma_c, lr, alpha, inv_temp, inv_s2, inv_ps2, mpf_lr,
     mpf_sigma, prior_bw0, log_mix) = scal.unbind()
    B, m, hz = theta0.shape
    m_mpf = mpfx0.shape[1]
    il_true, im_true = ep_f[:, 0], ep_f[:, 1]
    theta, locs, amat, x = theta0, locs0, amat0, mpfx0
    th_s = th0.expand(B)
    om_s = om0.expand(B)
    prior_bw = prior_bw0.expand(B)
    logs = []
    for t in range(steps):
        if eps is None:
            eps_t, pdz_t, pdu_t = device_noise(seeds, scenario, t, hz, m,
                                               n_act, n_params)
        else:
            eps_t, pdz_t, pdu_t = eps[:, t], pdz[:, t], pdu[:, t]

        bw_sv = silverman_rows(theta.reshape(B, m * hz))
        # dynamics-parameter draws from the live MPF prior
        idx = torch.clamp(torch.floor(pdu_t * float(m_mpf)),
                          max=float(m_mpf - 1)).long()
        pick = torch.gather(x, 1, idx[..., None].expand(B, n_params, 2))
        draws = pick + prior_bw[:, None, None] * pdz_t
        if mpf_log_space:
            draws = torch.exp(draws)
        il = 1.0 / draws[..., 0]
        im = 1.0 / draws[..., 1]

        acts = theta.transpose(1, 2)[..., None] + sigma_c * eps_t
        mcost = rollout_mcost(th_s, om_s, acts, il, im, dt, g_model)
        omega, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                               exp_util)
        # delta and likelihood gradient in the theta + sigma*sum(w eps)
        # form (the weights sum to 1), the sums in the kernel's order
        d_eps, w_eps = (lane_sum(w[:, None] * eps_t, SUM_LANES)[..., 0]
                        .transpose(1, 2) for w in (omega, w_lik))
        delta = theta + sigma_c * d_eps
        if a_seq is not None:
            delta = delta - a_seq
        glik = sigma_c * w_eps * inv_s2
        theta_new, theta_fwd, _, a_sel = stein_forward(
            theta, locs, glik, log_mix, bw_sv, lr, inv_ps2, log_l)

        # warm-up gate: no action, keep the optimized particles and prior
        if t >= warm_up:
            action = a_sel[:, 0]
            theta, locs = theta_fwd, theta_fwd
        else:
            action = torch.zeros_like(a_sel[:, 0])
            theta = theta_new
        amat = amat + delta

        # simulator: gym Pendulum-v0 physics with the true parameters
        a_cl = torch.clamp(action, -_MAX_TORQUE, _MAX_TORQUE)
        om2 = om_s + ((-3.0 * g_sim * 0.5) * il_true
                      * torch.sin(th_s + math.pi)
                      + 3.0 * im_true * il_true * il_true * a_cl) * dt
        om2 = torch.clamp(om2, -_MAX_SPEED, _MAX_SPEED)
        th2 = th_s + om2 * dt
        cost_t = _SWINGUP_W * (torch.cos(th2) - 1.0) ** 2 + om2 * om2

        # MPF update; its prior bandwidth is the previous step's
        if mpf_fixed_bw is not None:
            bw_mpf = torch.full_like(th2, float(mpf_fixed_bw))
        else:
            flat = torch.cat([x[..., 0], x[..., 1]], dim=-1)
            bw_mpf = silverman_rows(flat) * mpf_bw_scale
        mscal = torch.stack([
            bw_mpf, prior_bw, mpf_lr.expand(B), mpf_sigma.expand(B), th_s,
            om_s, a_cl, th2, om2,
        ], dim=-1)
        x = pendulum_mpf_optimize_plain(x, x, mscal,
                                        lanes=EPISODE_ROW_LANES,
                                        n_steps=mpf_steps, dt=dt, g=g_model,
                                        log_space=mpf_log_space)
        prior_bw = bw_mpf
        logs.append(torch.stack([th2, om2, action, cost_t, bw_sv, bw_mpf],
                                dim=-1))
        th_s, om_s = th2, om2
    return torch.stack(logs, dim=1), theta, locs, amat, x


# -- launch -------------------------------------------------------------------


def episode_statics(steps, warm_up, hz, m, n_params, n_act, m_mpf, mpf_steps,
                    dt, g_model, g_sim, exp_util, mpf_log_space, mpf_fixed_bw,
                    mpf_bw_scale):
    return dict(steps=int(steps), warm_up=int(warm_up), hz=int(hz), m=int(m),
                n_params=int(n_params), n_act=int(n_act), m_mpf=int(m_mpf),
                mpf_steps=int(mpf_steps), dt=float(dt),
                g_model=float(g_model), g_sim=float(g_sim),
                exp_util=bool(exp_util), mpf_log_space=bool(mpf_log_space),
                mpf_fixed_bw=(None if mpf_fixed_bw is None
                              else float(mpf_fixed_bw)),
                mpf_bw_scale=float(mpf_bw_scale))


def episode_plain(inputs, st):
    """The plain version on canonical inputs (see
    `episode_kernel.run_episodes`), on the device they lie on."""
    skip = ("m", "hz", "m_mpf")
    return pendulum_episode_plain(
        **inputs, **{k: v for k, v in st.items() if k not in skip})


def _pendulum_scalars(st):
    dt = st["dt"]
    return (
        st["steps"], st["warm_up"], st["hz"], st["m"], st["n_params"],
        st["n_act"], st["m_mpf"], st["mpf_steps"],
        # constants folded in double precision, as the plain version folds
        dt, _MAX_SPEED * dt, -3.0 * st["g_model"] * 0.5 * dt, 3.0 * dt,
        3.0 * st["g_model"] * 0.5, -3.0 * st["g_sim"] * 0.5,
        math.log(float(st["n_act"])), *mpf_scalars(st),
    )


# K4 and K5 (csrc/pendulum_episode.cu) for `episode_kernel.run_episodes`
PENDULUM = EpisodeKernel(
    entry="dust_pendulum_episodes",
    # looked up at each call, so that a test can swap the module's
    plain=lambda inputs, st: episode_plain(inputs, st),
    log_fields=LOG_FIELDS, clock=phase_clock,
    pointers=("scal", "ep_f", "ep_i", "theta0", "locs0", "amat0", "a_seq",
              "mpfx0"),
    host_noise=True, scalars=_pendulum_scalars)


def _episode(
        runner, seed, state0, theta0, locs0, a_mat0, a_seq0, mpfx0, prior_bw0,
        true_length, true_mass, ctrl_sigma, lr, alpha, temp, prior_sigma,
        mpf_lr, mpf_sigma, *, steps, warm_up=0, hz, m, n_params, n_act,
        m_mpf, mpf_steps, dt=0.05, g_model=9.8, g_sim=10.0, exp_util=True,
        mpf_log_space=False, mpf_fixed_bw=None, mpf_bw_scale=1.0,
        unroll=False, host_eps=None, host_pdz=None, host_pdu=None):
    """`fused_pendulum_episode`, with the runner of the canonical inputs
    (the kernel or the plain version) first."""
    if hz > 128 or n_act > 128 or m > 8:
        raise ValueError("episode kernel: hz<=128, n_act<=128, m<=8")
    if m_mpf > 64:
        raise ValueError("episode kernel: m_mpf <= 64 (one lane row)")
    if n_params > 8:
        raise ValueError("episode kernel: n_params <= 8 (one draw row each)")
    dev = torch.as_tensor(theta0).device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    st = episode_statics(steps, warm_up, hz, m, n_params, n_act, m_mpf,
                         mpf_steps, dt, g_model, g_sim, exp_util,
                         mpf_log_space, mpf_fixed_bw, mpf_bw_scale)
    inputs = dict(
        scal=episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma,
                          mpf_lr, mpf_sigma, prior_bw0, m, dev),
        ep_f=torch.stack([1.0 / f32(true_length).reshape(()),
                          1.0 / f32(true_mass).reshape(())])[None],
        seeds=torch.as_tensor(seed, dtype=torch.int64,
                              device=dev).reshape(1, 2),
        scenario=torch.zeros((1,), dtype=torch.int64, device=dev),
        theta0=f32(theta0).reshape(1, m, hz),
        locs0=f32(locs0).reshape(1, m, hz),
        amat0=f32(a_mat0).reshape(1, m, hz),
        a_seq=f32(a_seq0).reshape(hz),
        mpfx0=f32(mpfx0).reshape(1, m_mpf, 2),
        eps=None, pdz=None, pdu=None,
    )
    if host_eps is not None:
        inputs["eps"] = f32(host_eps)[:, :, :m, :n_act][None]
        inputs["pdz"] = f32(host_pdz)[:, :n_params, :2][None]
        inputs["pdu"] = f32(host_pdu)[:, :n_params, 0][None]
    log, theta, locs, amat, mpf_x = runner(inputs, st)
    out = split_log(log[0], LOG_FIELDS)
    out.update(theta=theta[0], locs=locs[0], a_mat=amat[0], mpf_x=mpf_x[0])
    return out


def _launch_k4(inputs, st):
    return run_episodes(fused_pendulum_episode, inputs, st, PENDULUM)


def fused_pendulum_episode(*args, **kwargs):
    """fused_pendulum_episode(seed, state0, theta0, locs0, a_mat0, a_seq0,
    mpfx0, prior_bw0, true_length, true_mass, ctrl_sigma, lr, alpha, temp,
    prior_sigma, mpf_lr, mpf_sigma, *, steps, warm_up=0, hz, m, n_params,
    n_act, m_mpf, mpf_steps, dt=0.05, g_model=9.8, g_sim=10.0,
    exp_util=True, mpf_log_space=False, mpf_fixed_bw=None,
    mpf_bw_scale=1.0, unroll=False, host_eps=None, host_pdz=None,
    host_pdu=None)

    Run one whole pendulum DuSt episode.

    seed int [2] (device-RNG mode; ignored in host-noise mode); state0 [2]
    initial (theta, theta_dot); theta0/locs0/a_mat0 [m, hz]; a_seq0 [hz];
    mpfx0 [m_mpf, 2]; prior_bw0 the initial MPF prior bandwidth;
    true_length/true_mass the simulator's parameters. `unroll` selects a
    TPU loop form and changes no value.

    Host-noise mode: host_eps [steps, hz, 8, 128] (rows q < m, lanes
    i < n_act used), host_pdz [steps, 8, 128] (lanes 0:2), host_pdu
    [steps, 8, 128] (lane 0). Actions are theta[q, t] + ctrl_sigma *
    eps[t, q, i]; the p-th dynamics draw is mpfx[floor(u_p * m_mpf)] +
    prior_bw * z_p.

    Returns a dict: th/om/action/cost/bw_sv/bw_mpf [steps], final
    theta/locs/a_mat [m, hz], mpf_x [m_mpf, 2]. CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    `fused_pendulum_episode.launches`)."""
    return _episode(_launch_k4, *args, **kwargs)


fused_pendulum_episode.launches = 0
fused_pendulum_episode.mpf_reg_launches = 0
fused_pendulum_episode.mpf_smem_launches = 0


def plain_pendulum_episode(*args, **kwargs):
    """`fused_pendulum_episode`'s plain version on the inputs' device, with
    the same arguments (the kernel's reference on the card)."""
    return _episode(episode_plain, *args, **kwargs)
