"""Whole cart-pole DuSt swing-up episodes in one launch (K14), with the
cart-pole's plain arithmetic. The port's own kernel: the JAX package has
no cart-pole episode kernel.

`steps` iterations of

  SVMPC solve (action noise, (length, mass_pole) draws from the live MPF
  prior, all n_params x m x n_act rollouts of the cart-pole step and the
  swing-up cost, DISCO update, Stein step, selection, roll) -> simulator
  step (`models.CartPoleModel.step` with the episode's true parameters,
  the pole mass times `load_scale` from step `load_step` on) -> MPF update
  (Silverman bandwidth, `mpf_steps` Stein iterations on the cart-pole's
  likelihood gradient, prior refresh)

run as one program; nothing returns to the host until the episode ends.
Each step's log holds (x, x_dot, th, th_dot, action, cost, bw_sv, bw_mpf).
The state is [x, x_dot, th, th_dot], upright at th = 0; the action is a
force in [-1, 1] times `f_mag`.

The kernel draws its noise from the pendulum episode's counter-based
stream, with the same draw indices (`episode.device_noise`). The plain
version also takes the draws as tensors (eps [B, steps, hz, m, n_act],
pdz [B, steps, n_params, 2], pdu [B, steps, n_params]), so a test can
feed it and another implementation the same noise.

* On CUDA tensors `episode_kernel.run_episodes(..., KERNEL)` launches
  the hand-written kernel `csrc/cartpole_episode.cu`: one block per
  episode, the rollouts and likelihood gradient in `csrc/cartpole.cuh`,
  the SVMPC solve in `stein.cuh`, the MPF Stein loop K4/K5's
  (`pendulum_mpf.cuh:stein_loop`).
* On CPU tensors it runs `cartpole_episode_plain`, the same arithmetic in
  plain PyTorch, batched over episodes (its MPF loop is
  `ops/mpf.py:stein_loop_plain` with `lik_grad`).
"""

from __future__ import annotations

import math

import torch

from .episode import CLOCK_PHASES, device_noise, episode_scal, silverman_rows
from .episode_kernel import EpisodeKernel, mpf_scalars
from .phase_clock import PhaseClock

LOG_FIELDS = ("x", "x_dot", "th", "th_dot", "action", "cost", "bw_sv",
              "bw_mpf")
# the kernel's clocked build times K5's phases (csrc/cartpole_episode.cu,
# kClkNoise ... kClkLog); `with phase_clock() as rows:` launches it
phase_clock = PhaseClock(CLOCK_PHASES)
# lanes that share one entry's sum over the action samples in the kernel's
# DISCO delta (csrc/cartpole_episode.cu:kSumLanes)
SUM_LANES = 8
# draws whose rollout chains a thread of the kernel advances together
# (csrc/cartpole_episode.cu:kChainDraws)
CHAIN_DRAWS = 4
# models/cartpole.py's constants of the step, in the kernel's order
MODEL_KEYS = ("g", "mass_cart", "mu_c", "mu_p", "f_mag")
# the swing-up cost (csrc/cartpole.cuh:state_cost)
ANGLE_W = 50.0
CART_VEL_W = 0.1
TRACK = 2.4          # models.CartPoleModel.x_threshold
TRACK_COST = 1e3
FOUR_THIRDS = 4.0 / 3


# -- the cart-pole's arithmetic ------------------------------------------------


def state_cost(x, xd, c, thd):
    """The swing-up cost of a state, c = cos th: 50 (c - 1)^2 + th_dot^2 +
    x^2 + 0.1 x_dot^2, plus 1e3 off the track (|x| > 2.4)."""
    v = ANGLE_W * ((c - 1.0) * (c - 1.0)) + thd * thd + x * x \
        + CART_VEL_W * (xd * xd)
    return v + torch.where(torch.abs(x) > TRACK, TRACK_COST, 0.0).to(v.dtype)


def accel(xd, s, c, thd, f, length, mp, model):
    """(x_dd, th_dd) of `models.CartPoleModel.step`, in its order of
    operations: cart speed xd, s / c the sine and cosine of th, pole speed
    thd, the clamped and scaled force f, the parameters (length, mp).
    model: {g, mass_cart, mu_c, mu_p} numbers."""
    M = model["mass_cart"] + mp
    pm = mp * length
    cf = model["mu_c"] * torch.sign(xd)
    pf = (model["mu_p"] * thd) / pm
    factor = ((f + (pm * s) * (thd * thd)) - cf) / M
    num = ((model["g"] * s) - (c * factor)) - pf
    den = length * (FOUR_THIRDS - (mp * (c * c)) / M)
    tdd = num / den
    return factor - ((pm * tdd) * c) / M, tdd


def force(action, model):
    return torch.clamp(action, -1.0, 1.0) * model["f_mag"]


def step(x, xd, th, thd, action, length, mp, model, dt):
    """One cart-pole step (explicit Euler on the old speeds)."""
    xdd, tdd = accel(xd, torch.sin(th), torch.cos(th), thd,
                     force(action, model), length, mp, model)
    return x + xd * dt, xd + xdd * dt, th + thd * dt, thd + tdd * dt


def rollout_mcost(state, acts, lens, mps, model, dt):
    """Param-averaged swing-up costs of every rollout, the kernel's order:
    state [B, 4]; acts [B, hz, m, n_act] (before the clamp); lens / mps
    [B, n_params] the draws. Costs of the states 0 .. hz added in turn,
    then the draws' sums in draw order. -> [B, m, n_act]."""
    B, hz, m, n_act = acts.shape
    n_params = lens.shape[1]
    zs = torch.zeros((B, n_params, m, n_act), dtype=acts.dtype,
                     device=acts.device)
    x, xd, th, thd = (zs + state[:, i].reshape(-1, 1, 1, 1)
                      for i in range(4))
    length = lens[:, :, None, None]
    mp = mps[:, :, None, None]
    cost = zs
    for t in range(hz):
        s, c = torch.sin(th), torch.cos(th)
        cost = cost + state_cost(x, xd, c, thd)
        xdd, tdd = accel(xd, s, c, thd, force(acts[:, t], model)[:, None],
                         length, mp, model)
        x, xd, th, thd = (x + xd * dt, xd + xdd * dt, th + thd * dt,
                          thd + tdd * dt)
    cost = cost + state_cost(x, xd, torch.cos(th), thd)
    mcost = cost[:, 0]
    for p in range(1, n_params):
        mcost = mcost + cost[:, p]
    return mcost * (1.0 / n_params)


def lik_grad(s0, action, s1, sigma, model, dt, log_space):
    """The MPF's likelihood gradient (csrc/cartpole.cuh:CartPoleLik): the
    gradient of -|f(s0, action; l, mp) - s1|^2 / (2 sigma^2) with respect
    to a particle (l, mp), derived by hand (the chain is written out in
    the header), with respect to their logs under `log_space`. s0, s1
    [..., 4] and action, sigma [...] of one transition per leading index.
    Returns lik(x0, x1) -> (gl0, gl1) for particle columns [..., m, 1], as
    `ops/mpf.py:stein_loop_plain` takes it."""
    col = lambda v: v[..., None, None]
    f = col(force(action, model))
    xd0, th0, thd0 = (col(s0[..., i]) for i in (1, 2, 3))
    xd1, thd1 = col(s1[..., 1]), col(s1[..., 3])
    cf = model["mu_c"] * torch.sign(xd0)
    sn, cs = torch.sin(th0), torch.cos(th0)
    w2 = thd0 * thd0
    gsn = model["g"] * sn
    cc = cs * cs
    mpthd = model["mu_p"] * thd0
    inv_s2 = 1.0 / (col(sigma) * col(sigma))
    mc = model["mass_cart"]

    def lik(x0, x1):
        length, mp = x0, x1
        if log_space:
            length = torch.exp(length)
            mp = torch.exp(mp)
        # ---- the predicted speeds (the model's step) ----
        M = mc + mp
        pm = mp * length
        pf = mpthd / pm
        factor = ((f + (pm * sn) * w2) - cf) / M
        num = (gsn - (cs * factor)) - pf
        q = FOUR_THIRDS - (mp * cc) / M
        den = length * q
        tdd = num / den
        xdd = factor - ((pm * tdd) * cs) / M
        r_xd = (xd0 + xdd * dt) - xd1
        r_thd = (thd0 + tdd * dt) - thd1
        # ---- their derivatives ----
        iM = 1.0 / M
        il = 1.0 / length
        imp = 1.0 / mp
        iden = 1.0 / den
        snw2 = sn * w2
        dfac_dl = (mp * snw2) * iM
        dfac_dm = ((length * snw2) - factor) * iM
        dnum_dl = (pf * il) - (cs * dfac_dl)
        dnum_dm = (pf * imp) - (cs * dfac_dm)
        iM2 = iM * iM
        dden_dm = length * (-(cc * mc) * iM2)
        dtdd_dl = (dnum_dl - tdd * q) * iden
        dtdd_dm = (dnum_dm - tdd * dden_dm) * iden
        dxdd_dl = dfac_dl - ((mp * cs) * iM) * (tdd + length * dtdd_dl)
        dxdd_dm = dfac_dm - (length * cs) * ((mc * iM2) * tdd
                                             + (mp * iM) * dtdd_dm)
        cx = -(r_xd * dt) * inv_s2
        ct = -(r_thd * dt) * inv_s2
        gl_l = cx * dxdd_dl + ct * dtdd_dl
        gl_m = cx * dxdd_dm + ct * dtdd_dm
        if log_space:
            gl_l = gl_l * length
            gl_m = gl_m * mp
        return gl_l, gl_m

    return lik


# -- the episode, batched -----------------------------------------------------


def cartpole_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma, mpf_lr,
                  mpf_sigma, prior_bw0, m, device):
    """[x0, x_dot0, ctrl_sigma, lr, alpha, inv_temp, inv_s2, inv_ps2,
    mpf_lr, mpf_sigma, prior_bw0, log_mix, th0, th_dot0]: the pendulum's
    `episode_scal` of the state's first two values, then its last two."""
    head = episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma,
                        mpf_lr, mpf_sigma, prior_bw0, m, device)
    tail = torch.as_tensor(state0, dtype=torch.float32,
                           device=device).reshape(-1)[2:4]
    return torch.cat([head, tail])


def cartpole_episode_plain(scal, ep_f, seeds, scenario, theta0, locs0, amat0,
                           mpfx0, eps=None, pdz=None, pdu=None, *, steps,
                           n_params, n_act, mpf_steps, dt, model, load_step,
                           load_scale, exp_util, mpf_log_space, mpf_fixed_bw,
                           mpf_bw_scale):
    """Plain PyTorch version of the kernel over B independent episodes.

    scal [14] as built by `cartpole_scal`; ep_f [B, 2] (true length, true
    mass_pole); seeds [B, 2], scenario [B] int64 (the counter-based
    noise's keys); theta0/locs0/amat0 [B, m, hz]; mpfx0 [B, m_mpf, 2]
    (length, mass_pole). eps [B, steps, hz, m, n_act], pdz [B, steps,
    n_params, 2], pdu [B, steps, n_params], when given, replace the
    counter-based draws. model: {g, mass_cart, mu_c, mu_p, f_mag}. Returns
    (log [B, steps, 8], theta, locs, a_mat [B, m, hz], mpf_x
    [B, m_mpf, 2])."""
    from .mpf import EPISODE_ROW_LANES, stein_loop_plain
    from .particle_mpf import lane_sum
    from .solve import disco_weights, stein_forward

    (x0, xd0, sigma_c, lr, alpha, inv_temp, inv_s2, inv_ps2, mpf_lr,
     mpf_sigma, prior_bw0, log_mix, th0, thd0) = scal.unbind()
    B, m, hz = theta0.shape
    m_mpf = mpfx0.shape[1]
    l_true, mp_true = ep_f[:, 0], ep_f[:, 1]
    theta, locs, amat, x = theta0, locs0, amat0, mpfx0
    state = torch.stack([x0, xd0, th0, thd0]).expand(B, 4)
    prior_bw = prior_bw0.expand(B)
    col = lambda v: v[:, None, None]
    logs = []
    for t in range(steps):
        if eps is None:
            eps_t, pdz_t, pdu_t = device_noise(seeds, scenario, t, hz, m,
                                               n_act, n_params)
        else:
            eps_t, pdz_t, pdu_t = eps[:, t], pdz[:, t], pdu[:, t]

        bw_sv = silverman_rows(theta.reshape(B, m * hz))
        # (length, mass_pole) draws from the live MPF prior
        idx = torch.clamp(torch.floor(pdu_t * float(m_mpf)),
                          max=float(m_mpf - 1)).long()
        pick = torch.gather(x, 1, idx[..., None].expand(B, n_params, 2))
        draws = pick + prior_bw[:, None, None] * pdz_t
        if mpf_log_space:
            draws = torch.exp(draws)

        acts = theta.transpose(1, 2)[..., None] + sigma_c * eps_t
        mcost = rollout_mcost(state, acts, draws[..., 0], draws[..., 1],
                              model, dt)
        omega, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                               exp_util)
        # delta and likelihood gradient in the theta + sigma*sum(w eps)
        # form (the weights sum to 1), the sums in the kernel's order
        d_eps, w_eps = (lane_sum(w[:, None] * eps_t, SUM_LANES)[..., 0]
                        .transpose(1, 2) for w in (omega, w_lik))
        delta = theta + sigma_c * d_eps
        glik = sigma_c * w_eps * inv_s2
        _, theta_fwd, _, a_sel = stein_forward(
            theta, locs, glik, log_mix, bw_sv, lr, inv_ps2, log_l)
        action = a_sel[:, 0]
        theta, locs = theta_fwd, theta_fwd
        amat = amat + delta

        # simulator: the cart-pole with the true parameters, the load on
        mp = mp_true * load_scale if t >= load_step else mp_true
        new = torch.stack(step(*state.unbind(-1), action, l_true, mp, model,
                               dt), dim=-1)
        cost_t = state_cost(new[:, 0], new[:, 1], torch.cos(new[:, 2]),
                            new[:, 3])

        # MPF update; its prior bandwidth is the previous step's
        if mpf_fixed_bw is not None:
            bw_mpf = torch.full_like(cost_t, float(mpf_fixed_bw))
        else:
            flat = torch.cat([x[..., 0], x[..., 1]], dim=-1)
            bw_mpf = silverman_rows(flat) * mpf_bw_scale
        lik = lik_grad(state, action, new, mpf_sigma.expand(B), model, dt,
                       mpf_log_space)
        x = stein_loop_plain(x, x, col(bw_mpf), col(prior_bw),
                             col(mpf_lr.expand(B)), lik,
                             lanes=EPISODE_ROW_LANES, n_steps=mpf_steps)
        prior_bw = bw_mpf
        logs.append(torch.cat([new, torch.stack(
            [action, cost_t, bw_sv, bw_mpf], dim=-1)], dim=-1))
        state = new
    return torch.stack(logs, dim=1), theta, locs, amat, x


# -- launch -------------------------------------------------------------------


def episode_statics(steps, hz, m, n_params, n_act, m_mpf, mpf_steps, dt,
                    model, load_step, load_scale, exp_util, mpf_log_space,
                    mpf_fixed_bw, mpf_bw_scale):
    return dict(steps=int(steps), hz=int(hz), m=int(m),
                n_params=int(n_params), n_act=int(n_act), m_mpf=int(m_mpf),
                mpf_steps=int(mpf_steps), dt=float(dt),
                model={k: float(model[k]) for k in MODEL_KEYS},
                load_step=int(load_step), load_scale=float(load_scale),
                exp_util=bool(exp_util), mpf_log_space=bool(mpf_log_space),
                mpf_fixed_bw=(None if mpf_fixed_bw is None
                              else float(mpf_fixed_bw)),
                mpf_bw_scale=float(mpf_bw_scale))


def episode_plain(inputs, st):
    """The plain version on canonical inputs (see
    `episode_kernel.run_episodes`), on the device they lie on."""
    skip = ("m", "hz", "m_mpf")
    return cartpole_episode_plain(
        **inputs, **{k: v for k, v in st.items() if k not in skip})


def _scalars(st):
    model = st["model"]
    return (
        st["steps"], st["hz"], st["m"], st["n_params"], st["n_act"],
        st["m_mpf"], st["mpf_steps"], st["load_step"], st["dt"],
        *(model[k] for k in MODEL_KEYS), st["load_scale"],
        math.log(float(st["n_act"])), *mpf_scalars(st),
    )


def rollout_guards(st, B):
    """The guarded chunk-steps of a launch of B episodes
    (`csrc/cartpole.cuh:rollout_mcost`): per episode step, each (particle,
    action sample) pair's chunks of CHAIN_DRAWS draws, each over the
    horizon's steps and its final cosine."""
    chunks = -(-st["n_params"] // CHAIN_DRAWS)
    return B * st["steps"] * st["m"] * st["n_act"] * chunks * (st["hz"] + 1)


# K14 for `episode_kernel.run_episodes`; its entry draws its own noise and
# counts its rollouts' fallbacks
KERNEL = EpisodeKernel(
    entry="dust_cartpole_episodes",
    # looked up at each call, so that a test can swap the module's
    plain=lambda inputs, st: episode_plain(inputs, st),
    log_fields=LOG_FIELDS, clock=phase_clock,
    pointers=("scal", "ep_f", "ep_i", "theta0", "locs0", "amat0", "mpfx0"),
    host_noise=False, scalars=_scalars, rollout_guards=rollout_guards)
