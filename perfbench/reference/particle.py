"""Plain reference of the particle configuration (the DuSt paper's
obstacle navigation, `demo/particle_config.yaml`), in plain PyTorch; it
imports nothing of the program.

`sweep_reference` runs whole DuSt episodes in device-RNG mode, batched
over episodes, with the arithmetic of the episode kernels: per step the
noise, the mass draws from the live MPF prior (log-mass, exp() into mass
space), Silverman's bandwidth of the policy particles, the SVMPC solve
(every rollout of a point mass on the obstacle map, DISCO update, Stein
step, selection and roll, the weighted prior refresh), the simulator with
the true mass (+ the load from a quarter of the episode), crash freeze and
the frozen state once done, the MPF mass-posterior update on the steps
that run it, the cost and the crash and goal tests. The obstacle map is
rasterised here from the config (`obstacle_rects`). Every function
computes in the floating type it is given, so the same code in bfloat16 is
the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._common import (
    bits_to_uniform,
    chain_seeds,
    counter_bits,
    disco_weights,
    lane_sum,
    normals_at,
    rng_key,
    silverman_rows,
    stein_forward,
)

SUM_LANES = 8      # the episode kernel's lanes per DISCO sum
MPF_LANES = 4      # lanes per MPF particle row
LOG_FIELDS = ("px", "py", "vx", "vy", "a_x", "a_y", "cost", "done",
              "crashed", "cum", "bw_sv", "bw_mpf")

# obstacle centres of the config's presets, in metres
_PRESETS = {
    "grid_4x4": [(i * 2.0, j * 2.0) for j in (3, 1, -1, -3)
                 for i in (-3, -1, 1, 3)],
}


# -- the map ---------------------------------------------------------------------


def _raster(env):
    """The occupancy raster of the config's map: each obstacle a square
    of `obst_width` rasterised with ceil cell math around its centre
    (snapped to whole metres), then walls 4 cells thick on the four
    edges; slices as numpy takes them (a negative start wraps)."""
    cs = float(env["map_cell_size"])
    nx = math.ceil(env["map_size"][0] / cs)
    ny = math.ceil(env["map_size"][1] / cs)
    grid = np.zeros((nx, ny), dtype=np.float32)
    ox, oy = int(nx / 2), int(ny / 2)

    def add(cx, cy, w, h):
        cx, cy = int(cx), int(cy)
        wc, hc = math.ceil(w / cs), math.ceil(h / cs)
        x0 = math.ceil(cx / cs) - math.ceil(wc / 2.0) + ox
        x1 = math.ceil(cx / cs) + math.ceil(wc / 2.0) + ox
        y0 = math.ceil(cy / cs) - math.ceil(hc / 2.0) + oy
        y1 = math.ceil(cy / cs) + math.ceil(hc / 2.0) + oy
        grid[x0:x1, y0:y1] = 1.0

    w = float(env["obst_width"])
    for cx, cy in _PRESETS[env["obst_preset"]]:
        add(cx, cy, w, w)
    xr, yr = cs * nx, cs * ny
    for lim in (-xr / 2, xr / 2):
        add(lim, 0, 4 * cs, yr)
    for lim in (-yr / 2, yr / 2):
        add(0, lim, xr, 4 * cs)
    return grid, (ox, oy)


def obstacle_rects(env):
    """(rects, grid): the occupied cells as half-open cell-index
    rectangles (runs along y merged over consecutive x rows) and the grid
    (1 / cell size, x and y offsets, largest x and y index)."""
    raster, (ox, oy) = _raster(env)
    rects, prev = [], {}
    for xi in range(raster.shape[0] + 1):
        cur = {}
        if xi < raster.shape[0]:
            row = np.concatenate(([False], raster[xi] > 0, [False]))
            edges = np.flatnonzero(np.diff(row.astype(np.int8)))
            for y0, y1 in edges.reshape(-1, 2):
                run = (int(y0), int(y1))
                cur[run] = prev.pop(run, xi)
        for (y0, y1), x0 in prev.items():
            rects.append((float(x0), float(xi), float(y0), float(y1)))
        prev = cur
    grid = (1.0 / float(env["map_cell_size"]), float(ox), float(oy),
            float(raster.shape[0] - 1), float(raster.shape[1] - 1))
    return tuple(rects), grid


def occupancy(px, py, rects, grid):
    """1 inside an obstacle cell, else 0 (the cell index clamped to the
    map)."""
    inv_cell, offx, offy, ximax, yimax = grid
    xi = torch.clamp(torch.floor(px * inv_cell + offx), 0.0, ximax)
    yi = torch.clamp(torch.floor(py * inv_cell + offy), 0.0, yimax)
    hit = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for x0, x1, y0, y1 in rects:
        hit = hit | ((xi >= x0) & (xi < x1) & (yi >= y0) & (yi < y1))
    return hit.to(px.dtype)


def statics(config):
    """The task's constants from the config: cost weights (state x, y,
    vx, vy; control x, y; obstacle; terminal x, y, vx, vy), target, dt,
    limits and the map."""
    env = config["env_params"]
    c = env["cost_params"]
    rects, grid = obstacle_rects(env)
    return dict(
        weights=(c["w_qpos"], c["w_qpos"], c["w_qvel"], c["w_qvel"],
                 c["w_ctrl"], c["w_ctrl"], float(np.float32(c["w_obs"])),
                 c["w_qpos_T"], c["w_qpos_T"], c["w_qvel_T"], c["w_qvel_T"]),
        target=tuple(float(v) for v in env["target_state"]),
        dt=float(env["dt"]), max_acc=float(env["max_accel"]),
        max_speed=float(env["max_speed"]), rects=rects, grid=grid,
        crash=bool(env["can_crash"] and env["with_obstacle"]))


# -- the rollouts -------------------------------------------------------------------


def _state_cost(px, py, vx, vy, occ, quad, target, w_obs):
    wpx, wpy, wvx, wvy = quad
    tx, ty, tvx, tvy = target
    return (wpx * (px - tx) ** 2 + wpy * (py - ty) ** 2
            + wvx * (vx - tvx) ** 2 + wvy * (vy - tvy) ** 2 + w_obs * occ)


def _rollout_mcost(s0, act, im, hz, st):
    """Mass-averaged navigation costs of every rollout: s0 [B, 4]; act(t)
    -> (a_x, a_y) [B, 1, m, n_act]; im [B, n_params]. -> [B, m, n_act]."""
    (w_px, w_py, w_vx, w_vy, w_cx, w_cy, w_obs,
     wt_px, wt_py, wt_vx, wt_vy) = st["weights"]
    rects, grid, target = st["rects"], st["grid"], st["target"]
    dt, max_acc, max_speed = st["dt"], st["max_acc"], st["max_speed"]
    B, n_params = im.shape
    im = im[:, :, None, None]
    a_x, _ = act(0)
    zs = torch.zeros((B, n_params) + tuple(a_x.shape[2:]), dtype=im.dtype,
                     device=im.device)
    px, py, vx, vy = (zs + s0[:, i].reshape(B, 1, 1, 1) for i in range(4))
    cost = zs
    for t in range(hz):
        occ = occupancy(px, py, rects, grid)
        a_x, a_y = act(t)
        cost = cost + (_state_cost(px, py, vx, vy, occ,
                                   (w_px, w_py, w_vx, w_vy), target, w_obs)
                       + w_cx * a_x * a_x + w_cy * a_y * a_y)
        acc_x = torch.clamp(a_x * im, -max_acc, max_acc)
        acc_y = torch.clamp(a_y * im, -max_acc, max_acc)
        scale = dt * (1.0 - occ) if st["crash"] else dt
        px, py = px + vx * scale, py + vy * scale
        vx = torch.clamp(vx + acc_x * scale, -max_speed, max_speed)
        vy = torch.clamp(vy + acc_y * scale, -max_speed, max_speed)
    cost = cost + _state_cost(px, py, vx, vy, occupancy(px, py, rects, grid),
                              (wt_px, wt_py, wt_vx, wt_vy), target, w_obs)
    mcost = cost[:, 0]
    for p in range(1, n_params):
        mcost = mcost + cost[:, p]
    return mcost * (1.0 / n_params)


# -- the mass posterior ----------------------------------------------------------------


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


def _mpf_update(x, prior_locs, sc, n_steps, max_acc, max_speed, log_space):
    """`n_steps` Stein iterations on (log-)mass particles x [B, m, 1]
    under the GMM prior at prior_locs and the Gaussian likelihood of the
    observed velocities; `sc` the per-episode scalars [B] by name."""
    bw, pbw, lr, sigma, v0x, v0y, ax, ay, loc_vx, loc_vy, scale = (
        sc[k][:, None, None] for k in ("bw", "pbw", "lr", "sigma", "v0x",
                                       "v0y", "ax", "ay", "loc_vx",
                                       "loc_vy", "scale"))
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    inv_s2 = 1.0 / (sigma * sigma)
    c0t = prior_locs.transpose(-1, -2)
    x0 = x
    for _ in range(n_steps):
        mass = torch.exp(x0) if log_space else x0
        invm = 1.0 / mass
        gl = (_vel_grad_term(ax, v0x, loc_vx, invm, scale, inv_s2, max_acc,
                             max_speed)
              + _vel_grad_term(ay, v0y, loc_vy, invm, scale, inv_s2,
                               max_acc, max_speed))
        if log_space:
            gl = gl * mass
        x0t = x0.transpose(-1, -2)
        logits = -0.5 * (x0 - c0t) ** 2 * inv_pbw2
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, pc = lane_sum(torch.stack([p, p * c0t]), MPF_LANES)
        s0 = gl + (pc / psum - x0) * inv_pbw2
        k = torch.exp(-0.5 * (x0 - x0t) ** 2 * inv_bw2)
        t0t = s0.transpose(-1, -2) - x0t * inv_bw2
        rows, drive0 = lane_sum(torch.stack([k, k * t0t]), MPF_LANES)
        phi0 = (drive0 + rows * x0 * inv_bw2) / float(m)
        x0 = x0 + lr * phi0
    return x0


# -- the sweep ------------------------------------------------------------------------


def _device_noise(seeds, scenario, step, hz, m, n_act, n_params, dtype):
    """One step's draws: action normals ((c * hz + t) * m + q) * n_act + i
    (c the x / y channel), mass normals n_eps + p, uniforms at uniform
    index 2 * (n_eps + n_params) + p."""
    dev = seeds.device
    key = rng_key(seeds[:, 0], seeds[:, 1], step, scenario).reshape(-1, 1)
    n_eps = 2 * hz * m * n_act
    eps = normals_at(key, torch.arange(n_eps, device=dev)).reshape(
        -1, 2, hz, m, n_act)
    pdz = normals_at(key, n_eps + torch.arange(n_params, device=dev))
    pdu = bits_to_uniform(counter_bits(
        key, 2 * (n_eps + n_params) + torch.arange(n_params, device=dev)))
    return eps.to(dtype), pdz.to(dtype), pdu.to(dtype)


def sweep_inputs(exp, arrays, seeds, masses, n_chains, dtype):
    """The B = G * n_chains * n_sc episodes of a sweep call, episode
    b = (g * n_chains + c) * n_sc + s: seeds [B, 2], scenario indices
    [B], base masses [B]. seeds [G, 2] int64; masses [G, n_sc]."""
    G, n_sc = masses.shape
    dev = masses.device
    seeds = chain_seeds(seeds, n_chains)
    B = G * n_chains * n_sc
    return dict(
        seeds=seeds[:, :, None].expand(G, n_chains, n_sc, 2).reshape(B, 2),
        scenario=torch.arange(n_sc, device=dev).repeat(G * n_chains),
        base_mass=masses.to(torch.float32)[:, None].expand(
            G, n_chains, n_sc).reshape(B).to(dtype),
    )


def sweep_reference(config, arrays, episodes, steps, episode_steps,
                    dtype=torch.float32):
    """The first `steps` steps of every episode of a sweep call of
    `episode_steps`-step episodes (the load comes at episode_steps // 4),
    in device-RNG mode. arrays: the benchmark's initial arrays (`theta0`
    [m, hz, 2], `locs0`, `mpf_init` [m_mpf, 1], `init_state` [4]);
    episodes: `sweep_inputs`. Returns {field: [B, steps]} of
    `LOG_FIELDS`."""
    exp = config["exp_params"]
    st = statics(config)
    f = lambda v: torch.as_tensor(v).to(dtype)
    seeds, scenario = episodes["seeds"], episodes["scenario"]
    base_mass = episodes["base_mass"]
    B = seeds.shape[0]
    m, hz = exp["n_particles"], exp["horizon"]
    ev = 2 * hz
    n_act, n_params = exp["action_samples"], exp["params_samples"]
    m_mpf, log_space = exp["mpf_n_particles"], exp["mpf_log_space"]
    alpha, sigma_c = float(exp["alpha"]), float(exp["ctrl_sigma"])
    inv_temp = alpha
    inv_s2 = 1.0 / sigma_c ** 2
    inv_ps2 = 1.0 / float(exp["prior_sigma"]) ** 2
    lr = float(exp["learning_rate"])
    load = float(exp["extra_load"])
    change_at = episode_steps // 4
    exp_util = exp["likelihood"] == "ExponentiatedUtility"
    (w_px, w_py, w_vx, w_vy, _, _, w_obs, _, _, _, _) = st["weights"]
    tx, ty, tvx, tvy = st["target"]
    dt, max_acc, max_speed = st["dt"], st["max_acc"], st["max_speed"]
    rects, grid = st["rects"], st["grid"]
    dev = seeds.device
    full = lambda v: torch.full((B,), float(v), dtype=dtype, device=dev)
    occ = lambda px, py: occupancy(px, py, rects, grid)

    theta = f(arrays["theta0"]).reshape(1, m, ev).expand(B, m, ev)
    locs = f(arrays["locs0"]).reshape(1, m, ev).expand(B, m, ev)
    x = f(arrays["mpf_init"]).reshape(1, m_mpf).expand(B, m_mpf)
    logmix = torch.full((B, m), -math.log(m), dtype=dtype, device=dev)
    state0 = f(arrays["init_state"])
    s = [state0[i].expand(B) for i in range(4)]
    lik = list(s)
    prior_bw = mpf_start_bw(exp, B, dtype, dev)
    bw_mpf = full(exp["mpf_bandwidth"])
    zero = torch.zeros(B, dtype=dtype, device=dev)
    done, crashed, cum = zero, zero, zero
    logs = []
    for t in range(steps):
        eps_t, pdz_t, pdu_t = _device_noise(seeds, scenario, t, hz, m,
                                            n_act, n_params, dtype)
        bw_sv = silverman_rows(theta.reshape(B, m * ev))
        idx = torch.clamp(torch.floor(pdu_t * float(m_mpf)),
                          max=float(m_mpf - 1)).long()
        draws = torch.gather(x, 1, idx) + prior_bw[:, None] * pdz_t
        if log_space:
            draws = torch.exp(draws)
        im = 1.0 / draws

        def act(tt):
            a_x = theta[:, :, 2 * tt, None] + sigma_c * eps_t[:, 0, tt]
            a_y = theta[:, :, 2 * tt + 1, None] + sigma_c * eps_t[:, 1, tt]
            return a_x[:, None], a_y[:, None]

        mcost = _rollout_mcost(torch.stack(s, dim=-1), act, im, hz, st)
        _, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha, exp_util)
        acts = theta[:, :, None, :] + sigma_c * eps_t.permute(
            0, 3, 4, 2, 1).reshape(B, m, n_act, ev)
        wa = lane_sum((w_lik[..., None] * acts).transpose(2, 3),
                      SUM_LANES)[..., 0]
        glik = (wa - theta) * inv_s2
        _, theta_fwd, weights, a_sel = stein_forward(
            theta, locs, glik, logmix, bw_sv, lr, inv_ps2, log_l, dim_a=2)
        a_x, a_y = a_sel[:, 0], a_sel[:, 1]
        theta, locs = theta_fwd, theta_fwd
        if exp["weighted_prior"]:
            lw = torch.log(torch.clamp(weights, min=1e-37))
            lmax = lw.amax(dim=-1, keepdim=True)
            logmix = lw - (lmax + torch.log(torch.exp(lw - lmax).sum(
                dim=-1, keepdim=True)))

        sim_mass = base_mass + load if t >= change_at else base_mass
        spx, spy, svx, svy = s
        s_scale = dt * (1.0 - occ(spx, spy)) if st["crash"] else dt
        acc_x = torch.clamp(a_x / sim_mass, -max_acc, max_acc)
        acc_y = torch.clamp(a_y / sim_mass, -max_acc, max_acc)
        frozen = done > 0.5
        new = (spx + svx * s_scale, spy + svy * s_scale,
               torch.clamp(svx + acc_x * s_scale, -max_speed, max_speed),
               torch.clamp(svy + acc_y * s_scale, -max_speed, max_speed))
        npx, npy, nvx, nvy = (torch.where(frozen, o, n)
                              for o, n in zip(s, new))

        x, prior_bw, lik = mpf_step(exp, st, x, prior_bw, lik, done, a_x,
                                    a_y, (npx, npy, nvx, nvy))

        occ_n = occ(npx, npy)
        cost_t = (w_px * (npx - tx) ** 2 + w_py * (npy - ty) ** 2
                  + w_vx * (nvx - tvx) ** 2 + w_vy * (nvy - tvy) ** 2
                  + w_obs * occ_n)
        cum = cum + (1.0 - done) * cost_t
        crash_now = occ_n > 0.0
        dist2 = ((tx - npx) ** 2 + (ty - npy) ** 2 + (tvx - nvx) ** 2
                 + (tvy - nvy) ** 2)
        success_now = dist2 <= 1.0
        crashed = torch.maximum(crashed, (crash_now & (done < 0.5)).to(dtype))
        done = torch.maximum(done, (crash_now | success_now).to(dtype))
        logs.append(torch.stack([npx, npy, nvx, nvy, a_x, a_y, cost_t, done,
                                 crashed, cum, bw_sv, bw_mpf], dim=-1))
        s = [npx, npy, nvx, nvy]
    log = torch.stack(logs, dim=1)
    return {k: log[..., i] for i, k in enumerate(LOG_FIELDS)}


def simulate(state, action, mass, config):
    """The simulator step of states [..., 4] under actions [..., 2] and
    masses [...]: the point mass's Euler step with the clamped
    acceleration and speed, frozen inside an obstacle cell."""
    st = statics(config)
    dt, max_acc, max_speed = st["dt"], st["max_acc"], st["max_speed"]
    px, py, vx, vy = state.unbind(-1)
    occ = occupancy(px, py, st["rects"], st["grid"])
    scale = dt * (1.0 - occ) if st["crash"] else dt
    acc_x = torch.clamp(action[..., 0] / mass, -max_acc, max_acc)
    acc_y = torch.clamp(action[..., 1] / mass, -max_acc, max_acc)
    return torch.stack([
        px + vx * scale, py + vy * scale,
        torch.clamp(vx + acc_x * scale, -max_speed, max_speed),
        torch.clamp(vy + acc_y * scale, -max_speed, max_speed)], dim=-1)


def state_cost(state, config, success_dist=1.0):
    """The cost of states [..., 4] (quadratic in the distance to the
    target, plus w_obs inside an obstacle) and whether each ends an
    episode (inside an obstacle, or within `success_dist` of the target
    in all four coordinates)."""
    st = statics(config)
    (w_px, w_py, w_vx, w_vy, _, _, w_obs, _, _, _, _) = st["weights"]
    tx, ty, tvx, tvy = st["target"]
    px, py, vx, vy = state.unbind(-1)
    occ = occupancy(px, py, st["rects"], st["grid"])
    cost = (w_px * (px - tx) ** 2 + w_py * (py - ty) ** 2
            + w_vx * (vx - tvx) ** 2 + w_vy * (vy - tvy) ** 2 + w_obs * occ)
    dist2 = ((tx - px) ** 2 + (ty - py) ** 2 + (tvx - vx) ** 2
             + (tvy - vy) ** 2)
    return cost, (occ > 0.0) | (dist2 <= success_dist * success_dist)


def mpf_start_bw(exp, B, dtype, device):
    """The MPF prior's bandwidth [B] at an episode's start:
    (2 * dyn_prior_arg2) ** 1 / 2, which the config's precedence makes
    dyn_prior_arg2 itself."""
    return torch.full((B,), float((2 * exp["dyn_prior_arg2"]) ** 1 / 2),
                      dtype=dtype, device=device)


def mpf_step(exp, st, x, prior_bw, lik, done, a_x, a_y, new_state):
    """One step's mass-posterior update of x [B, m_mpf] in the episodes
    not yet done (`done` before the step): `mpf_steps` Stein iterations
    under the GMM prior at x with `prior_bw` and the likelihood of the
    velocities `new_state` reached from the last state the MPF saw,
    `lik`, under the action (a_x, a_y). Returns (x, prior_bw, lik), each
    left as it was where the episode is done."""
    B = x.shape[0]
    full = lambda v: torch.full((B,), float(v), dtype=x.dtype,
                                device=x.device)
    dt = st["dt"]
    gate = done < 0.5
    mscale = (dt * (1.0 - occupancy(lik[0], lik[1], st["rects"],
                                    st["grid"]))
              if st["crash"] else full(dt))
    bw_mpf = full(exp["mpf_bandwidth"])
    sc = dict(bw=bw_mpf, pbw=prior_bw, lr=full(exp["mpf_learning_rate"]),
              sigma=full(exp["mpf_obs_std"]), v0x=lik[2], v0y=lik[3],
              ax=a_x, ay=a_y, loc_vx=new_state[2], loc_vy=new_state[3],
              scale=mscale)
    x_new = _mpf_update(x[..., None], x[..., None], sc, exp["mpf_steps"],
                        st["max_acc"], st["max_speed"],
                        exp["mpf_log_space"])[..., 0]
    x = torch.where(gate[:, None], x_new, x)
    prior_bw = torch.where(gate, bw_mpf, prior_bw)
    lik = [torch.where(gate, n, o) for o, n in zip(lik, new_state)]
    return x, prior_bw, lik


def mpf_chain(config, arrays, logs, dtype=torch.float32):
    """The MPF alone over every step of B logged episodes: each step's
    update driven by the logged action, the logged state after it and the
    logged `done` before it (the MPF update draws no noise). logs:
    {"px", "py", "vx", "vy", "a_x", "a_y", "done"} [B, steps]. Returns
    the final (log-)mass particles [B, m_mpf]."""
    exp = config["exp_params"]
    st = statics(config)
    px, py, vx, vy, a_x, a_y, done = (
        logs[k].to(dtype) for k in ("px", "py", "vx", "vy", "a_x", "a_y",
                                    "done"))
    B, steps = px.shape
    m_mpf = exp["mpf_n_particles"]
    x = torch.as_tensor(arrays["mpf_init"]).to(dtype).reshape(
        1, m_mpf).expand(B, m_mpf)
    prior_bw = mpf_start_bw(exp, B, dtype, px.device)
    s0 = torch.as_tensor(arrays["init_state"]).to(dtype)
    lik = [s0[i].expand(B) for i in range(4)]
    done_prev = torch.zeros(B, dtype=dtype, device=px.device)
    for t in range(steps):
        x, prior_bw, lik = mpf_step(
            exp, st, x, prior_bw, lik, done_prev, a_x[:, t], a_y[:, t],
            (px[:, t], py[:, t], vx[:, t], vy[:, t]))
        done_prev = done[:, t]
    return x
