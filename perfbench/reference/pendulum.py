"""Plain reference of the pendulum configuration (the DuSt paper's
swing-up, `demo/pendulum_config.yaml`), in plain PyTorch; it imports
nothing of the program.

* `sweep_reference`: whole DuSt episodes in device-RNG mode, batched over
  episodes, the arithmetic of the episode kernels (one SVMPC solve of
  n_params x m x n_act rollouts, DISCO update, Stein step, selection and
  roll; the simulator with the true parameters at g = 10; the MPF's
  Silverman bandwidth and `mpf_steps` Stein iterations with the
  likelihood gradient through the transition in closed form).
* `mpf_chain`: the MPF alone over every step of logged episodes, driven
  by their logged states and actions (the MPF update draws no noise), so
  it follows the program's posterior over the whole episode.

Every function computes in the floating type it is given, so the same
code in bfloat16 is the lower-precision control.
"""

from __future__ import annotations

import math

import torch

from ._common import (
    chain_seeds,
    counter_bits,
    bits_to_uniform,
    disco_weights,
    lane_sum,
    normals_at,
    rng_key,
    silverman_rows,
    silverman_statsmodels,
    stein_forward,
)

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
SWINGUP_W = 50.0
DT = 0.05
G_MODEL = 9.8      # the rollout and MPF model's gravity
G_SIM = 10.0       # the simulator's (gym Pendulum-v0)
SUM_LANES = 8      # the episode kernels' lanes per DISCO sum
MPF_LANES = 4      # the episode kernels' lanes per MPF particle row
LOG_FIELDS = ("th", "om", "action", "cost", "bw_sv", "bw_mpf")


# -- the sweep ------------------------------------------------------------------


def _rot_sincos(x, xmax):
    """sin / cos of the rotation om * dt with |x| <= xmax: Taylor
    polynomials below float32 rounding for xmax <= 1, exact above."""
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


def _rollout_mcost(th0, om0, acts, il, im):
    """Param-averaged swing-up costs of every rollout: th0 / om0 [B];
    acts [B, hz, m, n_act]; il / im [B, n_params]. -> [B, m, n_act]."""
    n_params = il.shape[1]
    hz = acts.shape[1]
    il = il[:, :, None, None]
    im = im[:, :, None, None]
    c_grav = (-3.0 * G_MODEL * 0.5 * DT) * il
    c_act = (3.0 * DT) * im * il * il
    shape = (acts.shape[0], n_params) + tuple(acts.shape[2:])
    zs = torch.zeros(shape, dtype=acts.dtype, device=acts.device)
    th = th0.reshape(-1, 1, 1, 1)
    c = zs + torch.cos(th)
    s = zs + torch.sin(th)
    om = zs + om0.reshape(-1, 1, 1, 1)
    cost = zs
    xmax = MAX_SPEED * DT
    for t in range(hz):
        cost = cost + SWINGUP_W * (c - 1.0) ** 2 + om * om
        a = torch.clamp(acts[:, t].unsqueeze(1), -MAX_TORQUE, MAX_TORQUE)
        om = om + c_grav * (-s) + c_act * a
        om = torch.clamp(om, -MAX_SPEED, MAX_SPEED)
        sd, cd = _rot_sincos(om * DT, xmax)
        c, s = c * cd - s * sd, s * cd + c * sd
    cost = cost + SWINGUP_W * (c - 1.0) ** 2 + om * om
    mcost = cost[:, 0]
    for p in range(1, n_params):
        mcost = mcost + cost[:, p]
    return mcost * (1.0 / n_params)


def _mpf_update(x, prior_locs, bw, pbw, lr, sigma, theta0, theta_d0, action,
                loc0, loc1, n_steps, log_space, lanes=MPF_LANES):
    """`n_steps` Stein iterations on particles x [B, m, 2] (length, mass)
    under the GMM prior at prior_locs (bandwidth pbw) and the Gaussian
    likelihood of the observed transition; the likelihood gradient in
    closed form, the sums in the kernel's lane order. Scalars [B]."""
    bw, pbw, lr, sigma, theta0, theta_d0, action, loc0, loc1 = (
        v[:, None, None] for v in (bw, pbw, lr, sigma, theta0, theta_d0,
                                   action, loc0, loc1))
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    inv_s2 = 1.0 / (sigma * sigma)
    acts = torch.clamp(action, -MAX_TORQUE, MAX_TORQUE)
    sin_t = torch.sin(theta0 + math.pi)
    half3g = 3.0 * G_MODEL * 0.5
    c0t = prior_locs[..., :, 0].unsqueeze(-2)
    c1t = prior_locs[..., :, 1].unsqueeze(-2)
    x0 = x[..., :, 0:1]
    x1 = x[..., :, 1:2]
    for _ in range(n_steps):
        length, mass = x0, x1
        if log_space:
            length = torch.exp(length)
            mass = torch.exp(mass)
        il = 1.0 / length
        im = 1.0 / mass
        tdd = (-half3g) * il * sin_t + 3.0 * im * il * il * acts
        theta_d_raw = theta_d0 + DT * tdd
        theta_d = torch.clamp(theta_d_raw, -MAX_SPEED, MAX_SPEED)
        theta = theta0 + theta_d * DT
        gate = ((theta_d_raw > -MAX_SPEED)
                & (theta_d_raw < MAX_SPEED)).to(x.dtype)
        dtd_dl = gate * DT * (half3g * il * il * sin_t
                              - 6.0 * im * il * il * il * acts)
        dtd_dm = gate * DT * (-3.0 * im * im * il * il * acts)
        common = -((theta - loc0) * DT + (theta_d - loc1)) * inv_s2
        gl_l = common * dtd_dl
        gl_m = common * dtd_dm
        if log_space:
            gl_l = gl_l * length
            gl_m = gl_m * mass
        d2c = (x0 - c0t) ** 2 + (x1 - c1t) ** 2
        logits = -0.5 * d2c * inv_pbw2
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, pc0, pc1 = lane_sum(torch.stack([p, p * c0t, p * c1t]),
                                  lanes)
        gp0 = (pc0 / psum - x0) * inv_pbw2
        gp1 = (pc1 / psum - x1) * inv_pbw2
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


def _device_noise(seeds, scenario, step, hz, m, n_act, n_params, dtype):
    """One step's draws: action normals (t * m + q) * n_act + i, parameter
    normals n_eps + 2p + j, component uniforms at uniform index
    2 * (n_eps + 2 n_params) + p."""
    dev = seeds.device
    key = rng_key(seeds[:, 0], seeds[:, 1], step, scenario).reshape(-1, 1)
    n_eps = hz * m * n_act
    eps = normals_at(key, torch.arange(n_eps, device=dev)).reshape(
        -1, hz, m, n_act)
    pdz = normals_at(key, n_eps + torch.arange(2 * n_params, device=dev))
    pdu = bits_to_uniform(counter_bits(
        key, 2 * (n_eps + 2 * n_params) + torch.arange(n_params,
                                                       device=dev)))
    return (eps.to(dtype), pdz.reshape(-1, n_params, 2).to(dtype),
            pdu.to(dtype))


def sweep_inputs(exp, arrays, seeds, lengths, masses, n_chains, dtype):
    """The B = G * n_chains * n_sc episodes of a sweep call, episode
    b = (g * n_chains + c) * n_sc + s: their seeds [B, 2], scenario
    indices [B], 1/length and 1/mass [B]. seeds [G, 2] int64; lengths /
    masses [G, n_sc]."""
    G, n_sc = lengths.shape
    dev = lengths.device
    seeds = chain_seeds(seeds, n_chains)                   # [G, C, 2]
    B = G * n_chains * n_sc
    per = lambda v: v[:, None].expand(G, n_chains, n_sc).reshape(B)
    return dict(
        seeds=seeds[:, :, None].expand(G, n_chains, n_sc, 2).reshape(B, 2),
        scenario=torch.arange(n_sc, device=dev).repeat(G * n_chains),
        il=(1.0 / per(lengths.to(torch.float32))).to(dtype),
        im=(1.0 / per(masses.to(torch.float32))).to(dtype),
    )


def sweep_reference(exp, arrays, episodes, steps, dtype=torch.float32):
    """`steps` steps of every episode of a sweep call in device-RNG mode.
    exp: the config's `exp_params`; arrays: the benchmark's initial arrays
    (`theta0` [m, hz], `locs0`, `mpf_init` [m_mpf, 2], `init_state` [2]);
    episodes: `sweep_inputs`. Returns {field: [B, steps]} of
    `LOG_FIELDS`."""
    f = lambda v: torch.as_tensor(v).to(dtype)
    seeds, scenario = episodes["seeds"], episodes["scenario"]
    il_true, im_true = episodes["il"], episodes["im"]
    B = seeds.shape[0]
    m, hz = exp["n_particles"], exp["horizon"]
    n_act, n_params = exp["action_samples"], exp["params_samples"]
    m_mpf, log_space = exp["mpf_n_particles"], exp["mpf_log_space"]
    alpha, sigma_c = float(exp["alpha"]), float(exp["ctrl_sigma"])
    temp = 1.0 / alpha
    inv_temp = 1.0 / temp
    inv_s2 = 1.0 / sigma_c ** 2
    inv_ps2 = 1.0 / float(exp["prior_sigma"]) ** 2
    lr = float(exp["learning_rate"])
    exp_util = exp["likelihood"] == "ExponentiatedUtility"

    theta = f(arrays["theta0"]).reshape(1, m, hz).expand(B, m, hz)
    locs = f(arrays["locs0"]).reshape(1, m, hz).expand(B, m, hz)
    x, prior_bw = mpf_start(exp, arrays, B, dtype)
    state0 = f(arrays["init_state"])
    th_s, om_s = state0[0].expand(B), state0[1].expand(B)
    log_mix = torch.tensor(-math.log(m), dtype=dtype, device=theta.device)
    logs = []
    for t in range(steps):
        eps_t, pdz_t, pdu_t = _device_noise(seeds, scenario, t, hz, m,
                                            n_act, n_params, dtype)
        bw_sv = silverman_rows(theta.reshape(B, m * hz))
        idx = torch.clamp(torch.floor(pdu_t * float(m_mpf)),
                          max=float(m_mpf - 1)).long()
        pick = torch.gather(x, 1, idx[..., None].expand(B, n_params, 2))
        draws = pick + prior_bw[:, None, None] * pdz_t
        if log_space:
            draws = torch.exp(draws)
        il, im = 1.0 / draws[..., 0], 1.0 / draws[..., 1]

        acts = theta.transpose(1, 2)[..., None] + sigma_c * eps_t
        mcost = _rollout_mcost(th_s, om_s, acts, il, im)
        omega, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                               exp_util)
        _, w_eps = (lane_sum(w[:, None] * eps_t, SUM_LANES)[..., 0]
                    .transpose(1, 2) for w in (omega, w_lik))
        glik = sigma_c * w_eps * inv_s2
        _, theta_fwd, _, a_sel = stein_forward(
            theta, locs, glik, log_mix, bw_sv, lr, inv_ps2, log_l)
        action = a_sel[:, 0]
        theta, locs = theta_fwd, theta_fwd

        a_cl = torch.clamp(action, -MAX_TORQUE, MAX_TORQUE)
        om2 = om_s + ((-3.0 * G_SIM * 0.5) * il_true
                      * torch.sin(th_s + math.pi)
                      + 3.0 * im_true * il_true * il_true * a_cl) * DT
        om2 = torch.clamp(om2, -MAX_SPEED, MAX_SPEED)
        th2 = th_s + om2 * DT
        cost_t = SWINGUP_W * (torch.cos(th2) - 1.0) ** 2 + om2 * om2

        x, bw_mpf = mpf_step(exp, x, prior_bw, th_s, om_s, a_cl, th2, om2)
        prior_bw = bw_mpf
        logs.append(torch.stack([th2, om2, action, cost_t, bw_sv, bw_mpf],
                                dim=-1))
        th_s, om_s = th2, om2
    log = torch.stack(logs, dim=1)
    return {k: log[..., i] for i, k in enumerate(LOG_FIELDS)}


def simulate(th, om, action, il, im):
    """The sweeps' simulator step (gym Pendulum-v0 at g = 10, with the
    true 1/length and 1/mass) and the cost of the new state, on tensors
    of any shape, in the episode kernels' order of operations."""
    a = torch.clamp(action, -MAX_TORQUE, MAX_TORQUE)
    om2 = om + ((-3.0 * G_SIM * 0.5) * il * torch.sin(th + math.pi)
                + 3.0 * im * il * il * a) * DT
    om2 = torch.clamp(om2, -MAX_SPEED, MAX_SPEED)
    th2 = th + om2 * DT
    return th2, om2, SWINGUP_W * (torch.cos(th2) - 1.0) ** 2 + om2 * om2


def mpf_start(exp, arrays, B, dtype):
    """The MPF's particles [B, m_mpf, 2] at an episode's start and its
    prior bandwidth [B] (statsmodels' Silverman of the initial
    particles, averaged over the two parameters)."""
    x0 = torch.as_tensor(arrays["mpf_init"]).to(dtype)
    m_mpf = exp["mpf_n_particles"]
    x = x0.reshape(1, m_mpf, 2).expand(B, m_mpf, 2)
    return x, silverman_statsmodels(x0.reshape(m_mpf, 2)).mean().expand(B)


def mpf_step(exp, x, prior_bw, th_s, om_s, a_cl, th2, om2):
    """One step's MPF update of x [B, m_mpf, 2] after the transition
    (th_s, om_s) -> (th2, om2) under the clamped action a_cl: the
    bandwidth (fixed, or Silverman's on the particles), then `mpf_steps`
    Stein iterations under the GMM prior at x with `prior_bw`. Returns
    (x, bw)."""
    B = x.shape[0]
    full = lambda v: torch.full((B,), v, dtype=x.dtype, device=x.device)
    fixed_bw = exp.get("mpf_bandwidth")
    if fixed_bw is not None:
        bw = full(float(fixed_bw))
    else:
        flat = torch.cat([x[..., 0], x[..., 1]], dim=-1)
        bw = silverman_rows(flat) * float(exp["mpf_bandwidth_scaling"])
    x = _mpf_update(x, x, bw, prior_bw, full(float(exp["mpf_learning_rate"])),
                    full(float(exp["mpf_obs_std"])), th_s, om_s, a_cl, th2,
                    om2, exp["mpf_steps"], exp["mpf_log_space"])
    return x, bw


def mpf_chain(exp, arrays, logs, dtype=torch.float32):
    """The MPF alone over every step of B logged episodes: each step's
    update driven by the logged state before it (the initial state at the
    first), the logged action and the logged state after it. logs:
    {"th", "om", "action"} [B, steps]. Returns each step's bandwidth
    [B, steps] and the final particles [B, m_mpf, 2]."""
    th, om, action = (logs[k].to(dtype) for k in ("th", "om", "action"))
    B, steps = th.shape
    x, prior_bw = mpf_start(exp, arrays, B, dtype)
    s0 = torch.as_tensor(arrays["init_state"]).to(dtype)
    th_s, om_s = s0[0].expand(B), s0[1].expand(B)
    bws = []
    for t in range(steps):
        a_cl = torch.clamp(action[:, t], -MAX_TORQUE, MAX_TORQUE)
        x, bw = mpf_step(exp, x, prior_bw, th_s, om_s, a_cl, th[:, t],
                         om[:, t])
        prior_bw = bw
        bws.append(bw)
        th_s, om_s = th[:, t], om[:, t]
    return torch.stack(bws, dim=1), x
