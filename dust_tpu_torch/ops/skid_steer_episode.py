"""Whole skid-steer navigation DuSt episodes in one launch (K15), with the
skid-steer's plain arithmetic. The port's own kernel: the JAX package has
no skid-steer episode kernel.

`steps` iterations of

  SVMPC solve (action noise, (x_icr, wheel_radius, axial_distance) draws
  from the live MPF prior, all n_params x m x n_act rollouts of the
  kinematic step and the navigation cost through the occupancy map, DISCO
  update, Stein step, selection, roll; the warm-up gate and the weighted
  prior refresh) -> simulator step (`models.SkidSteerNavigation.step` with
  the episode's true parameters, x_icr times `load_scale` from step
  `load_step` on; crash freeze, the state frozen once done) -> MPF update
  (bandwidth, `mpf_steps` Stein iterations on the three-value particles
  under the skid-steer's likelihood gradient, prior refresh), gated on
  t >= warm_up and not done -> cost, crash and goal detection

run as one program; nothing returns to the host until the episode ends.
Each step's log holds (x, y, theta, v, omega, a_r, a_l, cost, done,
crashed, bw_sv, bw_mpf). The state is [x, y, theta, v, omega]; the action
the right and left wheel speeds. The map, cost weights and target are the
particle kernels' model array (`particle_rollout.model_tensor`), the
target's (px, py, vx, vy) slots holding (x, y, v, omega).

The kernel draws its noise from the counter-based stream of the other
episode kernels: per step the action normals ((c * hz + t) * m + q) *
n_act + i (c the right / left channel), then the parameter normals
n_eps + 3 p + k, then the uniforms at uniform index 2 * (n_eps +
3 n_params) + p (`device_noise`). The plain version also takes the draws
as tensors (eps [B, steps, 2, hz, m, n_act], pdz [B, steps, n_params, 3],
pdu [B, steps, n_params]), so a test can feed it and another
implementation the same noise.

* On CUDA tensors `episode_kernel.run_episodes(..., KERNEL)` launches
  the hand-written kernel `csrc/skid_steer_episode.cu`: one block per
  episode, the rollouts and likelihood gradient in `csrc/skid_steer.cuh`,
  the SVMPC solve in `stein.cuh`, the MPF Stein loop K5/K14's at three
  values a particle (`pendulum_mpf.cuh:episode_stein_loop`).
* On CPU tensors it runs `skid_steer_episode_plain`, the same arithmetic
  in plain PyTorch, batched over episodes (its MPF loop is
  `ops/mpf.py:stein_loop_plain` with `lik_grad`).
"""

from __future__ import annotations

import math

import torch

from .episode import (
    CLOCK_PHASES,
    _normals_at,
    bits_to_uniform,
    counter_bits,
    rng_key,
    silverman_rows,
)
from .episode_kernel import EpisodeKernel, mpf_scalars
from .phase_clock import PhaseClock

LOG_FIELDS = ("x", "y", "th", "v", "omega", "a_r", "a_l", "cost", "done",
              "crashed", "bw_sv", "bw_mpf")
# the values of an MPF particle: x_icr, wheel_radius, axial_distance
MPF_WIDTH = 3
# the kernel's clocked build times K5's phases (csrc/skid_steer_episode.cu,
# kClkNoise ... kClkLog); `with phase_clock() as rows:` launches it
phase_clock = PhaseClock(CLOCK_PHASES)
# lanes that share one entry's sum over the action samples in the kernel's
# DISCO delta (csrc/skid_steer_episode.cu:kSumLanes)
SUM_LANES = 8


def device_noise(seeds, scenario, step, hz, m, n_act, n_params):
    """One step's draws of the counter-based stream. seeds [B, 2], scenario
    [B] (int64 tensors). Returns eps [B, 2, hz, m, n_act], pdz
    [B, n_params, 3], pdu [B, n_params]."""
    dev = seeds.device
    key = rng_key(seeds[:, 0], seeds[:, 1], step, scenario).reshape(-1, 1)
    n_eps = 2 * hz * m * n_act
    n_z = MPF_WIDTH * n_params
    eps = _normals_at(key, torch.arange(n_eps, device=dev)).reshape(
        -1, 2, hz, m, n_act)
    pdz = _normals_at(key, n_eps + torch.arange(n_z, device=dev))
    pdu = bits_to_uniform(counter_bits(
        key, 2 * (n_eps + n_z) + torch.arange(n_params, device=dev)))
    return eps, pdz.reshape(-1, n_params, MPF_WIDTH), pdu


# -- the skid-steer's arithmetic ---------------------------------------------


def speeds(ar, al, lo, hi, r, b):
    """(v, omega) under the wheel speeds (ar, al), each clamped to
    [lo, hi], and the parameters (r, b) (csrc/skid_steer.cuh:speeds)."""
    R = torch.clamp(ar, lo, hi)
    L = torch.clamp(al, lo, hi)
    return ((R + L) * math.pi) * r, ((((R - L) * 2.0) * math.pi) * r) / b


def advance(x, y, th, v, w, s, c, scale, xicr):
    """The pose after a step of speeds (v, w), s / c the sine and cosine
    of the heading, over `scale` (dt, or dt (1 - occupancy))."""
    fwd = v * scale
    lat = ((-w) * xicr) * scale
    return (x + fwd * c) - lat * s, (y + fwd * s) + lat * c, th + w * scale


def rollout_mcost(s0, act, draws, st, lo, hi):
    """Param-averaged navigation costs of every rollout, the kernel's order:
    s0 [B, 5]; act(t) -> (a_r, a_l) [B, 1, m, n_act] (before the clamp);
    draws (x_icr, r, b) [B, n_params] each; st the rollout statics
    (`episode_statics`). Costs of the states 0 .. hz added in turn, then the
    draws' sums in draw order. -> [B, m, n_act]."""
    # the particle's state cost, over (x, y, v, omega)
    from .particle_rollout import _state_cost, occupancy

    (w_px, w_py, w_vx, w_vy, w_cx, w_cy, w_obs,
     wt_px, wt_py, wt_vx, wt_vy) = st["weights"]
    rects, grid, target = st["rects"], st["grid"], st["target"]
    dt = st["dt"]
    crash = st["crash"] and rects is not None
    xicr, r, b = (d[:, :, None, None] for d in draws)
    B, n_params = draws[0].shape
    a_r, _ = act(0)
    zs = torch.zeros((B, n_params) + tuple(a_r.shape[2:]),
                     dtype=torch.float32, device=a_r.device)
    x, y, th, v, w = (zs + s0[:, i].reshape(B, 1, 1, 1) for i in range(5))
    cost = zs
    for t in range(st["hz"]):
        occ = occupancy(x, y, rects, grid)
        a_r, a_l = act(t)
        cost = cost + (
            _state_cost(x, y, v, w, occ, (w_px, w_py, w_vx, w_vy), target,
                        w_obs)
            + w_cx * a_r * a_r + w_cy * a_l * a_l)
        scale = dt * (1.0 - occ) if crash else dt
        s, c = torch.sin(th), torch.cos(th)
        v, w = speeds(a_r, a_l, lo, hi, r, b)
        x, y, th = advance(x, y, th, v, w, s, c, scale, xicr)
    cost = cost + _state_cost(x, y, v, w, occupancy(x, y, rects, grid),
                              (wt_px, wt_py, wt_vx, wt_vy), target, w_obs)
    mcost = cost[:, 0]
    for p in range(1, n_params):
        mcost = mcost + cost[:, p]
    return mcost * (1.0 / n_params)


def lik_grad(s0, a_r, a_l, s1, scale, sigma, lo, hi, log_space):
    """The MPF's likelihood gradient (csrc/skid_steer.cuh:SkidLik): the
    gradient of -|f(s0, a; x_icr, r, b) - s1|^2 / (2 sigma^2) with respect
    to a particle (x_icr, r, b), derived by hand (the chain is written out
    in the header), with respect to their logs under `log_space`. s0, s1
    [..., 5]; a_r, a_l, scale (the step's dt, times the crash factor at
    s0), sigma [...] of one transition per leading index. Returns lik(x0,
    x1, x2) -> (g0, g1, g2) for particle columns [..., m, 1], as
    `ops/mpf.py:stein_loop_plain` takes it."""
    col = lambda v: v[..., None, None]
    R = torch.clamp(col(a_r), lo, hi)
    L = torch.clamp(col(a_l), lo, hi)
    sq = (R + L) * math.pi
    dq = ((R - L) * 2.0) * math.pi
    x0, y0, th0 = (col(s0[..., i]) for i in range(3))
    x1, y1, th1, v1, w1 = (col(s1[..., i]) for i in range(5))
    sn, cs = torch.sin(th0), torch.cos(th0)
    scale = col(scale)
    inv_s2 = 1.0 / (col(sigma) * col(sigma))

    def lik(p0, p1, p2):
        xicr, r, b = p0, p1, p2
        if log_space:
            xicr, r, b = torch.exp(xicr), torch.exp(r), torch.exp(b)
        # ---- the predicted state (the model's step) ----
        v = sq * r
        w = (dq * r) / b
        x, y, th = advance(x0, y0, th0, v, w, sn, cs, scale, xicr)
        ex, ey, eth = x - x1, y - y1, th - th1
        ev, ew = v - v1, w - w1
        # ---- its derivatives ----
        ea = ex * cs + ey * sn
        eb = ey * cs - ex * sn
        ib = 1.0 / b
        dw_dr = dq * ib
        dw_db = -(w * ib)
        dlat_dx = (-w) * scale
        dlat_dr = ((-dw_dr) * xicr) * scale
        dlat_db = ((-dw_db) * xicr) * scale
        dfwd_dr = sq * scale
        g_x = dlat_dx * eb
        g_r = dfwd_dr * ea + dlat_dr * eb
        g_r = g_r + eth * (dw_dr * scale)
        g_r = g_r + ev * sq
        g_r = g_r + ew * dw_dr
        g_b = dlat_db * eb + eth * (dw_db * scale)
        g_b = g_b + ew * dw_db
        g = [-(g_x * inv_s2), -(g_r * inv_s2), -(g_b * inv_s2)]
        if log_space:
            g = [g[0] * xicr, g[1] * r, g[2] * b]
        return tuple(g)

    return lik


# -- the episode, batched -----------------------------------------------------


def skid_steer_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma, mpf_lr,
                    mpf_sigma, prior_bw0, device):
    """[x0, y0, th0, v0, w0, ctrl_sigma, lr, alpha, inv_temp, inv_s2,
    inv_ps2, mpf_lr, mpf_sigma, prior_bw0] as one float32 tensor on
    `device` (no host sync for device scalars)."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).reshape(-1)

    return torch.cat([
        f(state0)[:5], f(ctrl_sigma), f(lr), f(alpha), 1.0 / f(temp),
        1.0 / f(ctrl_sigma) ** 2, 1.0 / f(prior_sigma) ** 2, f(mpf_lr),
        f(mpf_sigma), f(prior_bw0),
    ])


def skid_steer_episode_plain(scal, ep_f, seeds, scenario, log_mix0, theta0,
                             locs0, amat0, mpfx0, eps=None, pdz=None,
                             pdu=None, *, st, steps, warm_up, n_params, n_act,
                             mpf_steps, load_step, load_scale, lo, hi,
                             success_dist, exp_util, weighted_prior,
                             mpf_log_space, mpf_fixed_bw, mpf_bw_scale):
    """Plain PyTorch version of the kernel over B independent episodes.

    scal [14] as built by `skid_steer_scal`; ep_f [B, 3] (true x_icr,
    wheel_radius, axial_distance); seeds [B, 2], scenario [B] int64 (the
    counter-based noise's keys); log_mix0 [m]; theta0/locs0/amat0
    [B, m, hz * 2] (a_seq is zero); mpfx0 [B, m_mpf, 3]; st the rollout
    statics (`episode_statics`). eps [B, steps, 2, hz, m, n_act], pdz
    [B, steps, n_params, 3], pdu [B, steps, n_params], when given, replace
    the counter-based draws. Returns (log [B, steps, 12], theta, locs, a_mat
    [B, m, hz * 2], mpf_x [B, m_mpf, 3])."""
    from .mpf import EPISODE_ROW_LANES, stein_loop_plain
    from .particle_mpf import lane_sum
    from .particle_rollout import occupancy
    from .solve import disco_weights, stein_forward

    (x0, y0, th0, v0, w0, sigma_c, lr, alpha, inv_temp, inv_s2, inv_ps2,
     mpf_lr, mpf_sigma, prior_bw0) = scal.unbind()
    B, m, ev = theta0.shape
    hz = ev // 2
    m_mpf = mpfx0.shape[1]
    dev = theta0.device
    (w_px, w_py, w_vx, w_vy, _, _, w_obs, _, _, _, _) = st["weights"]
    tx, ty, tv, tw = st["target"]
    rects, grid, dt = st["rects"], st["grid"], st["dt"]
    crash = st["crash"] and rects is not None
    zero = torch.zeros(B, device=dev)

    def occ(px, py):
        return zero if rects is None else occupancy(px, py, rects, grid)

    xicr_true, r_true, b_true = ep_f.unbind(-1)
    theta, locs, amat, x = theta0, locs0, amat0, mpfx0
    logmix = log_mix0.expand(B, m)
    s = [v.expand(B) for v in (x0, y0, th0, v0, w0)]   # simulator state
    lik_s = list(s)                                     # MPF observation
    prior_bw = prior_bw0.expand(B)
    done, crashed = zero, zero
    col = lambda v: v[:, None, None]
    logs = []
    for t in range(steps):
        if eps is None:
            eps_t, pdz_t, pdu_t = device_noise(seeds, scenario, t, hz, m,
                                               n_act, n_params)
        else:
            eps_t, pdz_t, pdu_t = eps[:, t], pdz[:, t], pdu[:, t]

        bw_sv = silverman_rows(theta.reshape(B, m * ev))
        # (x_icr, wheel_radius, axial_distance) draws from the live MPF
        # prior
        idx = torch.clamp(torch.floor(pdu_t * float(m_mpf)),
                          max=float(m_mpf - 1)).long()
        pick = torch.gather(x, 1, idx[..., None].expand(B, n_params,
                                                        MPF_WIDTH))
        draws = pick + prior_bw[:, None, None] * pdz_t
        if mpf_log_space:
            draws = torch.exp(draws)

        def act(tt):
            a_r = theta[:, :, 2 * tt, None] + sigma_c * eps_t[:, 0, tt]
            a_l = theta[:, :, 2 * tt + 1, None] + sigma_c * eps_t[:, 1, tt]
            return a_r[:, None], a_l[:, None]

        mcost = rollout_mcost(torch.stack(s, dim=-1), act,
                              draws.unbind(-1), st, lo, hi)
        omega, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                               exp_util)
        # every action as [B, m, n_act, hz * 2]
        acts = theta[:, :, None, :] + sigma_c * eps_t.permute(
            0, 3, 4, 2, 1).reshape(B, m, n_act, ev)
        # the sums over the samples in the kernel's order (a_seq is zero)
        delta = lane_sum((omega[..., None] * acts).transpose(2, 3),
                         SUM_LANES)[..., 0]
        wa = lane_sum((w_lik[..., None] * acts).transpose(2, 3),
                      SUM_LANES)[..., 0]
        glik = (wa - theta) * inv_s2
        theta_new, theta_fwd, weights, a_sel = stein_forward(
            theta, locs, glik, logmix, bw_sv, lr, inv_ps2, log_l, dim_a=2)

        # warm-up gate: no action, keep the optimized particles and prior
        active = 1.0 if t >= warm_up else 0.0
        a_r, a_l = active * a_sel[:, 0], active * a_sel[:, 1]
        if active:
            theta, locs = theta_fwd, theta_fwd
        else:
            theta = theta_new
        amat = amat + delta
        if weighted_prior and active:
            lw_raw = torch.log(torch.maximum(
                weights, torch.tensor(1e-37, device=dev)))
            lmax = lw_raw.amax(dim=-1, keepdim=True)
            lse = lmax + torch.log(torch.exp(lw_raw - lmax).sum(
                dim=-1, keepdim=True))
            logmix = lw_raw - lse

        # simulator: the true parameters, the load on x_icr, crash freeze,
        # frozen once done
        xicr = xicr_true * load_scale if t >= load_step else xicr_true
        sx, sy, sth = s[0], s[1], s[2]
        s_scale = dt * (1.0 - occ(sx, sy)) if crash else dt
        v, w = speeds(a_r, a_l, lo, hi, r_true, b_true)
        moved = (*advance(sx, sy, sth, v, w, torch.sin(sth), torch.cos(sth),
                          s_scale, xicr), v, w)
        frozen = done > 0.5
        new = [torch.where(frozen, o, n) for o, n in zip(s, moved)]

        # MPF update, gated on t >= warm_up and not done; its prior
        # bandwidth is the previous update's
        gate = (active * (1.0 - done)) > 0.5
        if mpf_fixed_bw is not None:
            bw_mpf = torch.full((B,), float(mpf_fixed_bw), device=dev)
        else:
            flat = x.transpose(1, 2).reshape(B, MPF_WIDTH * m_mpf)
            bw_mpf = silverman_rows(flat) * mpf_bw_scale
        mscale = (dt * (1.0 - occ(lik_s[0], lik_s[1])) if crash
                  else torch.full((B,), dt, device=dev))
        lik = lik_grad(torch.stack(lik_s, -1), a_r, a_l,
                       torch.stack(new, -1), mscale, mpf_sigma.expand(B),
                       lo, hi, mpf_log_space)
        x_new = stein_loop_plain(x, x, col(bw_mpf), col(prior_bw),
                                 col(mpf_lr.expand(B)), lik,
                                 lanes=EPISODE_ROW_LANES, n_steps=mpf_steps)
        x = torch.where(gate[:, None, None], x_new, x)
        prior_bw = torch.where(gate, bw_mpf, prior_bw)
        lik_s = [torch.where(gate, n, o) for o, n in zip(lik_s, new)]

        # cost, then crash / goal detection against the pre-step done
        nx, ny, nv, nw = new[0], new[1], new[3], new[4]
        occ_n = occ(nx, ny)
        cost_t = (w_px * (nx - tx) ** 2 + w_py * (ny - ty) ** 2
                  + w_vx * (nv - tv) ** 2 + w_vy * (nw - tw) ** 2)
        if rects is not None:
            cost_t = cost_t + w_obs * occ_n
        crash_now = occ_n > 0.0
        dist2 = ((nx - tx) ** 2 + (ny - ty) ** 2 + (nv - tv) ** 2
                 + (nw - tw) ** 2)
        success_now = dist2 <= success_dist * success_dist
        crashed = torch.maximum(crashed,
                                (crash_now & (done < 0.5)).to(torch.float32))
        done = torch.maximum(done, (crash_now | success_now).to(torch.float32))
        logs.append(torch.stack([*new, a_r, a_l, cost_t, done, crashed, bw_sv,
                                 bw_mpf], dim=-1))
        s = new
    return torch.stack(logs, dim=1), theta, locs, amat, x


# -- launch -------------------------------------------------------------------


def skid_steer_kernel_statics(model):
    """A `models.SkidSteerNavigation`'s constants as the kernel takes them:
    dict(dt, lo, hi, weights, target, rects, grid, crash) of plain floats
    and tuples (the map read at the model's own cell size)."""
    from .particle_rollout import map_statics

    vals = lambda t: tuple(float(v) for v in t.detach().cpu().numpy())
    rects, grid = map_statics(model)
    low, high = model.action_space.low, model.action_space.high
    if float(low[0]) != float(low[1]) or float(high[0]) != float(high[1]):
        raise ValueError("the skid-steer kernel takes one bound for both "
                         "wheels")
    return dict(dt=float(model.dt), lo=float(low[0]), hi=float(high[0]),
                weights=(*vals(model.w_state), *vals(model.w_ctrl),
                         float(model.w_obs), *vals(model.w_term)),
                target=vals(model.target), rects=rects, grid=grid,
                crash=bool(model.can_crash and model.with_obstacle))


def episode_statics(*, steps, warm_up=0, hz, m, n_params, n_act, m_mpf,
                    mpf_steps, dt, lo, hi, weights, target, rects, grid,
                    crash, load_step, load_scale=1.0, success_dist,
                    exp_util=True, weighted_prior=True, mpf_log_space=True,
                    mpf_fixed_bw=None, mpf_bw_scale=1.0):
    """The statics as `KERNEL` and `skid_steer_episode_plain` take them:
    the rollout statics `st` (hz, dt, weights, target, rects, grid, crash)
    and the episode's."""
    st = dict(hz=int(hz), dt=float(dt), weights=tuple(weights),
              target=tuple(target), rects=rects, grid=grid,
              crash=bool(crash))
    return dict(st=st, steps=int(steps), warm_up=int(warm_up), hz=int(hz),
                m=int(m), m_mpf=int(m_mpf), n_params=int(n_params),
                n_act=int(n_act), mpf_steps=int(mpf_steps),
                load_step=int(load_step), load_scale=float(load_scale),
                lo=float(lo), hi=float(hi), success_dist=float(success_dist),
                exp_util=bool(exp_util), weighted_prior=bool(weighted_prior),
                mpf_log_space=bool(mpf_log_space),
                mpf_fixed_bw=(None if mpf_fixed_bw is None
                              else float(mpf_fixed_bw)),
                mpf_bw_scale=float(mpf_bw_scale))


def episode_plain(inputs, sp):
    """The plain version on canonical inputs (see
    `episode_kernel.run_episodes`), on the device they lie on."""
    return skid_steer_episode_plain(
        **inputs, **{k: v for k, v in sp.items()
                     if k not in ("m", "hz", "m_mpf")})


def _model(sp, device):
    """The kernel's model array, from the rollout statics (its max_acc and
    max_speed slots unused)."""
    from .particle_rollout import model_tensor

    st = sp["st"]
    return {"model": model_tensor(st, st["dt"], 0.0, 0.0, device)}


def _scalars(sp):
    return (
        sp["steps"], sp["warm_up"], sp["hz"], sp["m"], sp["n_params"],
        sp["n_act"], sp["m_mpf"], sp["mpf_steps"], sp["load_step"],
        sp["lo"], sp["hi"], sp["load_scale"],
        float(sp["success_dist"]) * float(sp["success_dist"]),
        math.log(float(sp["n_act"])), int(sp["exp_util"]),
        int(sp["weighted_prior"]), *mpf_scalars(sp)[1:],
    )


def rollout_guards(sp, B):
    """The guarded rollout steps of a launch of B episodes
    (`csrc/skid_steer.cuh:step`): per episode step, every trajectory's
    horizon steps."""
    return (B * sp["steps"] * sp["n_params"] * sp["m"] * sp["n_act"]
            * sp["hz"])


# K15 for `episode_kernel.run_episodes`: a plan holds (a_r, a_l) per
# horizon step, an MPF particle (x_icr, wheel_radius, axial_distance); the
# entry draws its own noise and counts its rollouts' fallbacks
KERNEL = EpisodeKernel(
    entry="dust_skid_steer_episodes",
    # looked up at each call, so that a test can swap the module's
    plain=lambda inputs, sp: episode_plain(inputs, sp),
    log_fields=LOG_FIELDS, clock=phase_clock,
    pointers=("model", "scal", "ep_f", "ep_i", "log_mix0", "theta0",
              "locs0", "amat0", "mpfx0"),
    host_noise=False, scalars=_scalars, operands=_model, plan_width=2,
    mpf_width=MPF_WIDTH, rollout_guards=rollout_guards)
