"""Plain reference of the cart-pole configuration (the cart-pole swing-up
under DuSt), in plain float32 PyTorch; it imports nothing of the program.

The model is upstream lubaroli/dust `dust/models/cartpole.py` (Barto,
Sutton & Anderson 1983, with cart and pole friction), as the port fixed it:
the total mass is `mass_cart + mass_pole` (upstream adds the cart's mass
twice) and the sampled-parameter path works (upstream reads an attribute
that does not exist). The state is [x, x_dot, th, th_dot], upright at
th = 0; the action is a force in [-1, 1] times `f_mag`; one step is
explicit Euler on the old speeds. Departures of the configuration from
upstream, which ships no cart-pole demo (each under `assumed` in its
file): the swing-up cost, the start state, the prior, the sigmas, the tip
load.

* `sweep_reference`: whole DuSt episodes in device-RNG mode, batched over
  episodes: one SVMPC solve of n_params x m x n_act rollouts, DISCO
  update, Stein step, selection and roll (the pendulum's solve,
  `_common.py`); the simulator with the true parameters and the load; the
  MPF's Silverman bandwidth and `mpf_steps` Stein iterations.
* `mpf_chain`: the MPF alone over every step of logged episodes, driven by
  their logged states and actions.
* `simulate`: one step of the simulator and the cost of the new state.

The MPF's likelihood gradient comes from `torch.autograd` through the
step, never from a hand derivation, so it checks the program's algebra on
its own. Every function computes in the floating type it is given, so the
same code in bfloat16 is the lower-precision control.
"""

from __future__ import annotations

import math

import torch

from ._common import (
    chain_seeds,
    disco_weights,
    lane_sum,
    silverman_rows,
    stein_forward,
)
from .pendulum import _device_noise, mpf_start

# a float32 matrix product must not run in TF32 here
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUM_LANES = 8      # the episode kernels' lanes per DISCO sum
MPF_LANES = 4      # the episode kernels' lanes per MPF particle row
LOG_FIELDS = ("x", "x_dot", "th", "th_dot", "action", "cost", "bw_sv",
              "bw_mpf")


def _model(cfg):
    return cfg["model_params"]


def step(state, action, length, mass_pole, mdl):
    """One cart-pole step of states [..., 4] under actions [...] and the
    parameters (length, mass_pole) [...], as upstream writes it."""
    x_d = state[..., 1]
    theta = state[..., 2]
    theta_d = state[..., 3]
    acts = torch.clamp(action, -1.0, 1.0) * mdl["f_mag"]
    mass = mdl["mass_cart"] + mass_pole       # upstream: m_c + m_c
    pm = mass_pole * length
    cart_friction = mdl["mu_c"] * torch.sign(x_d)
    pole_friction = (mdl["mu_p"] * theta_d) / pm
    factor = (acts + pm * torch.sin(theta) * theta_d ** 2
              - cart_friction) / mass
    tdd_num = mdl["g"] * torch.sin(theta) - torch.cos(theta) * factor \
        - pole_friction
    tdd_den = length * (4.0 / 3 - (mass_pole * torch.cos(theta) ** 2) / mass)
    theta_dd = tdd_num / tdd_den
    x_dd = factor - pm * theta_dd * torch.cos(theta) / mass
    delta = torch.stack(torch.broadcast_tensors(x_d, x_dd, theta_d,
                                                theta_dd), dim=-1) * mdl["dt"]
    return state + delta


def cost(state):
    """The configuration's swing-up cost of states [..., 4]: 50 (cos th -
    1)^2 + th_dot^2 + x^2 + 0.1 x_dot^2, plus 1e3 off the track
    (|x| > 2.4)."""
    x, x_d, theta, theta_d = state.unbind(-1)
    c = 50.0 * (torch.cos(theta) - 1.0) ** 2 + theta_d ** 2 + x ** 2 \
        + 0.1 * x_d ** 2
    return c + (torch.abs(x) > 2.4).to(c.dtype) * 1e3


def _rollout_mcost(state, acts, lens, mps, mdl):
    """Param-averaged swing-up costs of every rollout: state [B, 4]; acts
    [B, hz, m, n_act]; lens / mps [B, n_params]. The costs of the states
    0 .. hz add in turn, the draws' in draw order. -> [B, m, n_act]."""
    B, hz, m, n_act = acts.shape
    n_params = lens.shape[1]
    s = state.reshape(B, 1, 1, 1, 4).expand(B, n_params, m, n_act, 4)
    length = lens.reshape(B, n_params, 1, 1)
    mass_pole = mps.reshape(B, n_params, 1, 1)
    total = torch.zeros((B, n_params, m, n_act), dtype=acts.dtype,
                        device=acts.device)
    for t in range(hz):
        total = total + cost(s)
        s = step(s, acts[:, t].unsqueeze(1), length, mass_pole, mdl)
    total = total + cost(s)
    mcost = total[:, 0]
    for p in range(1, n_params):
        mcost = mcost + total[:, p]
    return mcost * (1.0 / n_params)


def _lik_grad(x, s0, action, s1, sigma, mdl, log_space):
    """The gradient of the Gaussian observation log-likelihood of each
    transition s0 -> s1 under `action` with respect to the particles x
    [B, m, 2] (length, mass_pole; their logs under `log_space`), from
    torch.autograd through `step`."""
    with torch.enable_grad():
        xg = x.detach().clone().requires_grad_(True)
        p = torch.exp(xg) if log_space else xg
        pred = step(s0[:, None, :], action[:, None], p[..., 0], p[..., 1],
                    mdl)
        z = (pred - s1[:, None, :]) / sigma[:, None, None]
        (grad,) = torch.autograd.grad(-0.5 * (z * z).sum(), xg)
    return grad


def _mpf_update(x, prior_locs, bw, pbw, lr, sigma, s0, action, s1, n_steps,
                log_space, mdl, lanes=MPF_LANES):
    """`n_steps` Stein iterations on particles x [B, m, 2] under the GMM
    prior at prior_locs (bandwidth pbw) and the Gaussian likelihood of the
    observed transition (its gradient by autograd), the sums in the
    kernel's lane order. bw, pbw, lr, sigma, action [B]; s0, s1 [B, 4]."""
    bw, pbw, lr = (v[:, None, None] for v in (bw, pbw, lr))
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    c0t = prior_locs[..., :, 0].unsqueeze(-2)
    c1t = prior_locs[..., :, 1].unsqueeze(-2)
    for _ in range(n_steps):
        gl = _lik_grad(x, s0, action, s1, sigma, mdl, log_space)
        x0, x1 = x[..., :, 0:1], x[..., :, 1:2]
        d2c = (x0 - c0t) ** 2 + (x1 - c1t) ** 2
        logits = -0.5 * d2c * inv_pbw2
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, pc0, pc1 = lane_sum(torch.stack([p, p * c0t, p * c1t]),
                                  lanes)
        gp0 = (pc0 / psum - x0) * inv_pbw2
        gp1 = (pc1 / psum - x1) * inv_pbw2
        t0t = ((gl[..., 0:1] + gp0) - x0 * inv_bw2).transpose(-1, -2)
        t1t = ((gl[..., 1:2] + gp1) - x1 * inv_bw2).transpose(-1, -2)
        d2 = ((x0 - x0.transpose(-1, -2)) ** 2
              + (x1 - x1.transpose(-1, -2)) ** 2)
        k = torch.exp(-0.5 * d2 * inv_bw2)
        rows, drive0, drive1 = lane_sum(torch.stack([k, k * t0t, k * t1t]),
                                        lanes)
        phi0 = (drive0 + rows * x0 * inv_bw2) / m
        phi1 = (drive1 + rows * x1 * inv_bw2) / m
        x = torch.cat([x0 + lr * phi0, x1 + lr * phi1], dim=-1)
    return x


def sweep_inputs(exp, arrays, seeds, lengths, mass_poles, n_chains, dtype):
    """The B = G * n_chains * n_sc episodes of a sweep call, episode
    b = (g * n_chains + c) * n_sc + s: their seeds [B, 2], scenario
    indices [B], true length and pole mass [B]. seeds [G, 2] int64;
    lengths / mass_poles [G, n_sc]."""
    G, n_sc = lengths.shape
    dev = lengths.device
    seeds = chain_seeds(seeds, n_chains)                   # [G, C, 2]
    B = G * n_chains * n_sc
    per = lambda v: v[:, None].expand(G, n_chains, n_sc).reshape(B)
    return dict(
        seeds=seeds[:, :, None].expand(G, n_chains, n_sc, 2).reshape(B, 2),
        scenario=torch.arange(n_sc, device=dev).repeat(G * n_chains),
        length=per(lengths.to(torch.float32)).to(dtype),
        mass_pole=per(mass_poles.to(torch.float32)).to(dtype),
    )


def true_mass_pole(exp, mass_pole, t):
    """The simulator's pole mass at step t: the tip load multiplies it by
    `load_mass_pole_scale` from step `load_step` on."""
    if t >= exp.get("load_step", math.inf):
        return mass_pole * float(exp["load_mass_pole_scale"])
    return mass_pole


def sweep_reference(cfg, arrays, episodes, steps, dtype=torch.float32):
    """`steps` steps of every episode of a sweep call in device-RNG mode.
    cfg: the configuration (`exp_params`, `model_params`); arrays: the
    benchmark's initial arrays (`theta0` [m, hz], `locs0`, `mpf_init`
    [m_mpf, 2], `init_state` [4]); episodes: `sweep_inputs`. Returns
    {field: [B, steps]} of `LOG_FIELDS`."""
    exp, mdl = cfg["exp_params"], _model(cfg)
    f = lambda v: torch.as_tensor(v).to(dtype)
    seeds, scenario = episodes["seeds"], episodes["scenario"]
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
    state = f(arrays["init_state"]).reshape(1, 4).expand(B, 4)
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

        acts = theta.transpose(1, 2)[..., None] + sigma_c * eps_t
        mcost = _rollout_mcost(state, acts, draws[..., 0], draws[..., 1],
                               mdl)
        omega, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                               exp_util)
        _, w_eps = (lane_sum(w[:, None] * eps_t, SUM_LANES)[..., 0]
                    .transpose(1, 2) for w in (omega, w_lik))
        glik = sigma_c * w_eps * inv_s2
        _, theta_fwd, _, a_sel = stein_forward(
            theta, locs, glik, log_mix, bw_sv, lr, inv_ps2, log_l)
        action = a_sel[:, 0]
        theta, locs = theta_fwd, theta_fwd

        new = step(state, action, episodes["length"],
                   true_mass_pole(exp, episodes["mass_pole"], t), mdl)
        x, bw_mpf = mpf_step(cfg, x, prior_bw, state, action, new)
        prior_bw = bw_mpf
        logs.append(torch.cat([new, torch.stack(
            [action, cost(new), bw_sv, bw_mpf], dim=-1)], dim=-1))
        state = new
    log = torch.stack(logs, dim=1)
    return {k: log[..., i] for i, k in enumerate(LOG_FIELDS)}


def simulate(cfg, state, action, length, mass_pole, t):
    """The sweeps' simulator step from states [..., 4] under actions
    [...] with the true length and pole mass (the load from step
    `load_step` on, t [...] the step), and the cost of the new state.
    Returns (new states [..., 4], cost [...])."""
    exp, mdl = cfg["exp_params"], _model(cfg)
    loaded = torch.as_tensor(t, device=state.device) >= exp.get(
        "load_step", math.inf)
    mp = torch.where(loaded, mass_pole * float(exp.get(
        "load_mass_pole_scale", 1.0)), mass_pole)
    new = step(state, action, length, mp, mdl)
    return new, cost(new)


def mpf_step(cfg, x, prior_bw, s0, action, s1):
    """One step's MPF update of x [B, m_mpf, 2] after the transition s0 ->
    s1 [B, 4] under `action` [B]: the bandwidth (fixed, or Silverman's on
    the particles), then `mpf_steps` Stein iterations under the GMM prior
    at x with `prior_bw`. Returns (x, bw)."""
    exp = cfg["exp_params"]
    B = x.shape[0]
    full = lambda v: torch.full((B,), v, dtype=x.dtype, device=x.device)
    fixed_bw = exp.get("mpf_bandwidth")
    if fixed_bw is not None:
        bw = full(float(fixed_bw))
    else:
        flat = torch.cat([x[..., 0], x[..., 1]], dim=-1)
        bw = silverman_rows(flat) * float(exp["mpf_bandwidth_scaling"])
    x = _mpf_update(x, x, bw, prior_bw, full(float(exp["mpf_learning_rate"])),
                    full(float(exp["mpf_obs_std"])), s0, action, s1,
                    exp["mpf_steps"], exp["mpf_log_space"], _model(cfg))
    return x, bw


def mpf_chain(cfg, arrays, logs, dtype=torch.float32):
    """The MPF alone over every step of B logged episodes: each step's
    update driven by the logged state before it (the initial state at the
    first), the logged action and the logged state after it. logs:
    {"x", "x_dot", "th", "th_dot", "action"} [B, steps]. Returns each
    step's bandwidth [B, steps] and the final particles [B, m_mpf, 2]."""
    exp = cfg["exp_params"]
    states = torch.stack([logs[k].to(dtype) for k in LOG_FIELDS[:4]], -1)
    action = logs["action"].to(dtype)
    B, steps = action.shape
    x, prior_bw = mpf_start(exp, arrays, B, dtype)
    s0 = torch.as_tensor(arrays["init_state"]).to(dtype).expand(B, 4)
    bws = []
    for t in range(steps):
        x, bw = mpf_step(cfg, x, prior_bw, s0, action[:, t], states[:, t])
        prior_bw = bw
        bws.append(bw)
        s0 = states[:, t]
    return torch.stack(bws, dim=1), x
