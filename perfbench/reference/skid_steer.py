"""Plain reference of the skid-steer configuration (a skid-steer robot
crossing the particle demo's obstacle course under DuSt), in plain float32
PyTorch; it imports nothing of the program.

The model is upstream lubaroli/dust `dust/models/skid_steer_robot.py`, the
kinematic four-wheel skid-steer of Kozlowski & Pazderski (2004): the state
[x, y, theta, v, omega], the actions the right and left wheel speeds
clamped to [min_wheel_speed, max_wheel_speed], the uncertain parameters
the ICR x-offset, the wheel radius and the axial distance. Departures of
the configuration from upstream, which ships no skid-steer demo (each
under `assumed` in its file): the course (upstream's grid_3x3 preset of
the particle course, read at `map_scale` of its size) and its crash
freeze (a robot inside an obstacle cell stays in place, as the particle
does), the cost (the particle demo's over (x, y) and (v, omega), with the
tuned particle config's w_qvel_T), the start, target and goal distance,
dt, the sigmas, learning rate and initial policies, the prior and the MPF
bandwidth, the load on x_icr.

* `sweep_reference`: whole DuSt episodes in device-RNG mode, batched over
  episodes: one SVMPC solve of n_params x m x n_act rollouts on the map,
  DISCO update, Stein step, selection and roll, the weighted prior
  refresh (the particle's solve, `particle.py`); the simulator with the
  true parameters and the load, the crash freeze, the state frozen once
  done; the MPF's `mpf_steps` Stein iterations on the steps that run it;
  the cost and the crash and goal tests.
* `mpf_chain`: the MPF alone over every step of logged episodes, driven by
  their logged states, actions and `done`.
* `simulate`, `state_cost`: one step of the simulator; the cost of a state
  and whether it ends an episode.

The MPF's likelihood gradient comes from `torch.autograd` through the
step, never from a hand derivation, so it checks the program's algebra on
its own. Every function computes in the floating type it is given, so the
same code in bfloat16 is the lower-precision control.
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

# a float32 matrix product must not run in TF32 here
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUM_LANES = 8      # the episode kernel's lanes per DISCO sum
MPF_LANES = 4      # the episode kernel's lanes per MPF particle row
N_PARAMS = 3       # x_icr, wheel_radius, axial_distance
LOG_FIELDS = ("x", "y", "th", "v", "omega", "a_r", "a_l", "cost", "done",
              "crashed", "bw_sv", "bw_mpf")


# upstream's obstacle presets of the particle course, centres in metres of
# the unscaled map (dust/utils/obstacle_map.py)
_PRESETS = {
    "grid_3x3": [(i * 5.0, j * 5.0) for j in (1, 0, -1) for i in (-1, 0, 1)],
    "grid_4x4": [(i * 2.0, j * 2.0) for j in (3, 1, -1, -3)
                 for i in (-3, -1, 1, 3)],
}


def _raster(env):
    """The occupancy raster of the config's map, in cells of the unscaled
    map: each obstacle a square of `obst_width` rasterised with ceil cell
    math around its centre (snapped to whole metres), then walls 4 cells
    thick on the four edges; slices as numpy takes them (a negative start
    wraps)."""
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


def statics(config, device="cpu"):
    """The task's constants from the config: cost weights (x, y, v, omega;
    the two wheel speeds; obstacle; terminal x, y, v, omega), the target's
    (x, y, v, omega), dt, the wheel speeds' bounds, the map (the particle
    demo's raster, as a boolean tensor on `device`, its cell read at
    `map_scale` of its size), crash and the goal distance."""
    env = config["env_params"]
    mdl = config["model_params"]
    c = env["cost_params"]
    raster, (ox, oy) = _raster(env)
    grid = (1.0 / (float(env["map_cell_size"]) * float(env["map_scale"])),
            float(ox), float(oy), float(raster.shape[0] - 1),
            float(raster.shape[1] - 1))
    return dict(
        weights=(c["w_qpos"], c["w_qpos"], c["w_qvel"], c["w_qvel"],
                 c["w_ctrl"], c["w_ctrl"], float(c["w_obs"]),
                 c["w_qpos_T"], c["w_qpos_T"], c["w_qvel_T"], c["w_qvel_T"]),
        target=tuple(float(v) for v in env["target_state"]),
        dt=float(env["dt"]), lo=float(mdl["min_wheel_speed"]),
        hi=float(mdl["max_wheel_speed"]), grid=grid,
        raster=torch.from_numpy(raster > 0).reshape(-1).to(device),
        crash=bool(env["can_crash"] and env["with_obstacle"]),
        success_dist=float(env["success_dist"]))


def occupancy(px, py, st):
    """1 inside an obstacle cell, else 0 (the cell index clamped to the
    map; 0 at a NaN position), looked up in the raster."""
    inv_cell, offx, offy, ximax, yimax = st["grid"]
    xi = torch.clamp(torch.floor(px * inv_cell + offx), 0.0, ximax)
    yi = torch.clamp(torch.floor(py * inv_cell + offy), 0.0, yimax)
    ok = (xi == xi) & (yi == yi)
    cell = (torch.where(ok, xi, 0.0).long() * (int(yimax) + 1)
            + torch.where(ok, yi, 0.0).long())
    raster = st["raster"].to(px.device)
    return (raster[cell] & ok).to(px.dtype)


# -- the model ----------------------------------------------------------------


def step(state, action, x_icr, wheel_radius, axial_distance, st):
    """One step of states [..., 5] under actions [..., 2] and the
    parameters [...], as upstream writes it, the step's time dt times
    (1 - occupancy) where the course can crash."""
    x, y, theta = state[..., 0], state[..., 1], state[..., 2]
    right = torch.clamp(action[..., 0], st["lo"], st["hi"])
    left = torch.clamp(action[..., 1], st["lo"], st["hi"])
    dt = st["dt"]
    if st["crash"]:
        dt = dt * (1.0 - occupancy(x, y, st))
    linear_speed = (right + left) * math.pi * wheel_radius
    angular_speed = ((right - left) * 2 * math.pi * wheel_radius
                     / axial_distance)
    forward_shift = linear_speed * dt
    lateral_shift = -angular_speed * x_icr * dt
    new_x = x + forward_shift * torch.cos(theta) \
        - lateral_shift * torch.sin(theta)
    new_y = y + forward_shift * torch.sin(theta) \
        + lateral_shift * torch.cos(theta)
    new_theta = theta + angular_speed * dt
    return torch.stack(torch.broadcast_tensors(
        new_x, new_y, new_theta, linear_speed, angular_speed), dim=-1)


def _quad(state, weights, target):
    w_x, w_y, w_v, w_w = weights
    tx, ty, tv, tw = target
    return (w_x * (state[..., 0] - tx) ** 2 + w_y * (state[..., 1] - ty) ** 2
            + w_v * (state[..., 3] - tv) ** 2
            + w_w * (state[..., 4] - tw) ** 2)


def state_cost(state, config):
    """The cost of states [..., 5] (quadratic in the distance of (x, y, v,
    omega) to the target's, plus w_obs inside an obstacle) and whether each
    ends an episode (inside an obstacle, or within `success_dist` of the
    target in those four coordinates)."""
    return _state_cost(state, statics(config, state.device))


def _state_cost(state, st):
    w = st["weights"]
    occ = occupancy(state[..., 0], state[..., 1], st)
    cost = _quad(state, w[0:4], st["target"]) + w[6] * occ
    dist2 = _quad(state, (1.0, 1.0, 1.0, 1.0), st["target"])
    return cost, (occ > 0.0) | (dist2 <= st["success_dist"] ** 2)


def _rollout_mcost(s0, acts, draws, st):
    """Param-averaged navigation costs of every rollout: s0 [B, 5]; acts
    [B, hz, m, n_act, 2] (before the clamp); draws [B, n_params, 3]. The
    costs of the states 0 .. hz add in turn, the draws' in draw order.
    -> [B, m, n_act]."""
    B, hz, m, n_act, _ = acts.shape
    n_params = draws.shape[1]
    w = st["weights"]
    s = s0.reshape(B, 1, 1, 1, 5).expand(B, n_params, m, n_act, 5)
    p = [draws[..., k].reshape(B, n_params, 1, 1) for k in range(N_PARAMS)]
    total = torch.zeros((B, n_params, m, n_act), dtype=acts.dtype,
                        device=acts.device)
    for t in range(hz):
        a = acts[:, t].unsqueeze(1)
        occ = occupancy(s[..., 0], s[..., 1], st)
        total = total + (_quad(s, w[0:4], st["target"]) + w[6] * occ
                         + w[4] * a[..., 0] ** 2 + w[5] * a[..., 1] ** 2)
        s = step(s, a, *p, st)
    occ = occupancy(s[..., 0], s[..., 1], st)
    total = total + _quad(s, w[7:11], st["target"]) + w[6] * occ
    mcost = total[:, 0]
    for q in range(1, n_params):
        mcost = mcost + total[:, q]
    return mcost * (1.0 / n_params)


# -- the posterior over (x_icr, wheel_radius, axial_distance) -----------------


def _lik_grad(x, s0, action, s1, sigma, st, log_space):
    """The gradient of the Gaussian observation log-likelihood of each
    transition s0 -> s1 [B, 5] under `action` [B, 2] with respect to the
    particles x [B, m, 3] (their logs under `log_space`), from
    torch.autograd through `step`."""
    with torch.enable_grad():
        xg = x.detach().clone().requires_grad_(True)
        p = torch.exp(xg) if log_space else xg
        pred = step(s0[:, None, :], action[:, None, :], p[..., 0],
                    p[..., 1], p[..., 2], st)
        z = (pred - s1[:, None, :]) / sigma[:, None, None]
        (grad,) = torch.autograd.grad(-0.5 * (z * z).sum(), xg)
    return grad


def _mpf_update(x, bw, pbw, lr, sigma, s0, action, s1, n_steps, log_space,
                st):
    """`n_steps` Stein iterations on particles x [B, m, 3] under the GMM
    prior at x (bandwidth pbw) and the Gaussian likelihood of the observed
    transition (its gradient by autograd), the sums in the kernel's lane
    order. bw, pbw, lr, sigma [B]; s0, s1 [B, 5]; action [B, 2]."""
    bw, pbw, lr = (v[:, None, None] for v in (bw, pbw, lr))
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    ct = [x[..., :, k].unsqueeze(-2) for k in range(N_PARAMS)]
    for _ in range(n_steps):
        gl = _lik_grad(x, s0, action, s1, sigma, st, log_space)
        xs = [x[..., :, k:k + 1] for k in range(N_PARAMS)]
        d2c = sum((xs[k] - ct[k]) ** 2 for k in range(N_PARAMS))
        logits = -0.5 * d2c * inv_pbw2
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, *pc = lane_sum(torch.stack([p, *(p * c for c in ct)]),
                             MPF_LANES)
        tt = [((gl[..., k:k + 1] + (pc[k] / psum - xs[k]) * inv_pbw2)
               - xs[k] * inv_bw2).transpose(-1, -2) for k in range(N_PARAMS)]
        d2 = sum((xs[k] - xs[k].transpose(-1, -2)) ** 2
                 for k in range(N_PARAMS))
        k_ = torch.exp(-0.5 * d2 * inv_bw2)
        rows, *drive = lane_sum(torch.stack([k_, *(k_ * t for t in tt)]),
                                MPF_LANES)
        x = torch.cat([xs[k] + lr * ((drive[k] + rows * xs[k] * inv_bw2) / m)
                       for k in range(N_PARAMS)], dim=-1)
    return x


def mpf_start(exp, arrays, B, dtype):
    """The MPF particles [B, m_mpf, 3] and the prior bandwidth [B] at an
    episode's start: the initial particles, and the fixed bandwidth."""
    x = torch.as_tensor(arrays["mpf_init"]).to(dtype)
    m_mpf = exp["mpf_n_particles"]
    x = x.reshape(1, m_mpf, N_PARAMS).expand(B, m_mpf, N_PARAMS)
    return x, torch.full((B,), float(exp["mpf_bandwidth"]), dtype=dtype,
                         device=x.device)


def mpf_step(exp, st, x, prior_bw, lik, done, action, new_state):
    """One step's MPF update of x [B, m_mpf, 3] in the episodes not yet
    done (`done` before the step): the fixed bandwidth, then `mpf_steps`
    Stein iterations under the GMM prior at x with `prior_bw` and the
    likelihood of `new_state` [B, 5] reached from the last state the MPF
    saw, `lik` [B, 5], under `action` [B, 2]. Returns (x, prior_bw, lik,
    bw), each left as it was where the episode is done."""
    B = x.shape[0]
    full = lambda v: torch.full((B,), float(v), dtype=x.dtype,
                                device=x.device)
    gate = done < 0.5
    bw = full(exp["mpf_bandwidth"])
    x_new = _mpf_update(x, bw, prior_bw, full(exp["mpf_learning_rate"]),
                        full(exp["mpf_obs_std"]), lik, action, new_state,
                        exp["mpf_steps"], exp["mpf_log_space"], st)
    x = torch.where(gate[:, None, None], x_new, x)
    prior_bw = torch.where(gate, bw, prior_bw)
    lik = torch.where(gate[:, None], new_state, lik)
    return x, prior_bw, lik, bw


# -- the sweep ----------------------------------------------------------------


def _device_noise(seeds, scenario, step_i, hz, m, n_act, n_params, dtype):
    """One step's draws: action normals ((c * hz + t) * m + q) * n_act + i
    (c the right / left channel), parameter normals n_eps + 3 p + k,
    uniforms at uniform index 2 * (n_eps + 3 n_params) + p."""
    dev = seeds.device
    key = rng_key(seeds[:, 0], seeds[:, 1], step_i, scenario).reshape(-1, 1)
    n_eps = 2 * hz * m * n_act
    n_z = N_PARAMS * n_params
    eps = normals_at(key, torch.arange(n_eps, device=dev)).reshape(
        -1, 2, hz, m, n_act)
    pdz = normals_at(key, n_eps + torch.arange(n_z, device=dev)).reshape(
        -1, n_params, N_PARAMS)
    pdu = bits_to_uniform(counter_bits(
        key, 2 * (n_eps + n_z) + torch.arange(n_params, device=dev)))
    return eps.to(dtype), pdz.to(dtype), pdu.to(dtype)


def sweep_inputs(exp, arrays, seeds, x_icr, wheel_radius, axial_distance,
                 n_chains, dtype):
    """The B = G * n_chains * n_sc episodes of a sweep call, episode
    b = (g * n_chains + c) * n_sc + s: seeds [B, 2], scenario indices
    [B], the true parameters [B, 3]. seeds [G, 2] int64; the parameters
    [G, n_sc] each."""
    G, n_sc = x_icr.shape
    dev = x_icr.device
    seeds = chain_seeds(seeds, n_chains)
    B = G * n_chains * n_sc
    params = torch.stack([x_icr, wheel_radius, axial_distance], dim=-1)
    return dict(
        seeds=seeds[:, :, None].expand(G, n_chains, n_sc, 2).reshape(B, 2),
        scenario=torch.arange(n_sc, device=dev).repeat(G * n_chains),
        params=params.to(torch.float32)[:, None].expand(
            G, n_chains, n_sc, N_PARAMS).reshape(B, N_PARAMS).to(dtype),
    )


def true_params(exp, params, t, episode_steps):
    """The simulator's (x_icr, wheel_radius, axial_distance) [B] each at
    step t: x_icr times `extra_load` from a quarter of the episode
    on."""
    x_icr, r, b = params.unbind(-1)
    if t >= episode_steps // 4:
        x_icr = x_icr * float(exp["extra_load"])
    return x_icr, r, b


def sweep_reference(config, arrays, episodes, steps, episode_steps,
                    dtype=torch.float32):
    """The first `steps` steps of every episode of a sweep call of
    `episode_steps`-step episodes (the load comes at episode_steps // 4),
    in device-RNG mode. arrays: the benchmark's initial arrays (`theta0`
    [m, hz, 2], `locs0`, `mpf_init` [m_mpf, 3], `init_state` [5]);
    episodes: `sweep_inputs`. Returns {field: [B, steps]} of
    `LOG_FIELDS`."""
    exp = config["exp_params"]
    st = statics(config, episodes["seeds"].device)
    f = lambda v: torch.as_tensor(v).to(dtype)
    seeds, scenario = episodes["seeds"], episodes["scenario"]
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
    exp_util = exp["likelihood"] == "ExponentiatedUtility"
    dev = seeds.device

    theta = f(arrays["theta0"]).reshape(1, m, ev).expand(B, m, ev)
    locs = f(arrays["locs0"]).reshape(1, m, ev).expand(B, m, ev)
    x, prior_bw = mpf_start(exp, arrays, B, dtype)
    logmix = torch.full((B, m), -math.log(m), dtype=dtype, device=dev)
    state = f(arrays["init_state"]).reshape(1, 5).expand(B, 5)
    lik = state
    zero = torch.zeros(B, dtype=dtype, device=dev)
    done, crashed = zero, zero
    logs = []
    for t in range(steps):
        eps_t, pdz_t, pdu_t = _device_noise(seeds, scenario, t, hz, m,
                                            n_act, n_params, dtype)
        bw_sv = silverman_rows(theta.reshape(B, m * ev))
        idx = torch.clamp(torch.floor(pdu_t * float(m_mpf)),
                          max=float(m_mpf - 1)).long()
        pick = torch.gather(x, 1, idx[..., None].expand(B, n_params,
                                                        N_PARAMS))
        draws = pick + prior_bw[:, None, None] * pdz_t
        if log_space:
            draws = torch.exp(draws)

        # actions [B, hz, m, n_act, 2]: theta + sigma eps per channel
        plan = theta.reshape(B, m, hz, 2).permute(0, 2, 1, 3)[:, :, :, None]
        acts = plan + sigma_c * eps_t.permute(0, 2, 3, 4, 1)
        mcost = _rollout_mcost(state, acts, draws, st)
        _, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha, exp_util)
        flat = theta[:, :, None, :] + sigma_c * eps_t.permute(
            0, 3, 4, 2, 1).reshape(B, m, n_act, ev)
        wa = lane_sum((w_lik[..., None] * flat).transpose(2, 3),
                      SUM_LANES)[..., 0]
        glik = (wa - theta) * inv_s2
        _, theta_fwd, weights, a_sel = stein_forward(
            theta, locs, glik, logmix, bw_sv, lr, inv_ps2, log_l, dim_a=2)
        action = a_sel[:, 0:2]
        theta, locs = theta_fwd, theta_fwd
        if exp["weighted_prior"]:
            lw = torch.log(torch.clamp(weights, min=1e-37))
            lmax = lw.amax(dim=-1, keepdim=True)
            logmix = lw - (lmax + torch.log(torch.exp(lw - lmax).sum(
                dim=-1, keepdim=True)))

        moved = step(state, action, *true_params(
            exp, episodes["params"], t, episode_steps), st)
        new = torch.where((done > 0.5)[:, None], state, moved)
        x, prior_bw, lik, bw_mpf = mpf_step(exp, st, x, prior_bw, lik, done,
                                            action, new)
        cost, ended = _state_cost(new, st)
        occ = occupancy(new[:, 0], new[:, 1], st)
        crashed = torch.maximum(crashed,
                                ((occ > 0.0) & (done < 0.5)).to(dtype))
        done = torch.maximum(done, ended.to(dtype))
        logs.append(torch.cat([new, torch.stack(
            [action[:, 0], action[:, 1], cost, done, crashed, bw_sv, bw_mpf],
            dim=-1)], dim=-1))
        state = new
    log = torch.stack(logs, dim=1)
    return {k: log[..., i] for i, k in enumerate(LOG_FIELDS)}


def simulate(state, action, params, config, t, episode_steps):
    """The sweeps' simulator step from states [B, T, 5] under actions
    [B, T, 2] with the true parameters [B, 3] (the load on x_icr from a
    quarter of the episode, t [T] the step)."""
    exp = config["exp_params"]
    st = statics(config, state.device)
    x_icr, r, b = (params[:, None, k] for k in range(N_PARAMS))
    loaded = torch.as_tensor(t, device=state.device) >= episode_steps // 4
    x_icr = torch.where(loaded, x_icr * float(exp["extra_load"]),
                        x_icr)
    return step(state, action, x_icr, r, b, st)


def mpf_chain(config, arrays, logs, dtype=torch.float32):
    """The MPF alone over every step of B logged episodes: each step's
    update driven by the logged action, the logged state after it and the
    logged `done` before it (the MPF update draws no noise). logs:
    {"x", "y", "th", "v", "omega", "a_r", "a_l", "done"} [B, steps].
    Returns the final particles [B, m_mpf, 3]."""
    exp = config["exp_params"]
    st = statics(config, logs["x"].device)
    states = torch.stack([logs[k].to(dtype) for k in LOG_FIELDS[:5]], -1)
    action = torch.stack([logs[k].to(dtype) for k in ("a_r", "a_l")], -1)
    done = logs["done"].to(dtype)
    B, steps = done.shape
    x, prior_bw = mpf_start(exp, arrays, B, dtype)
    lik = torch.as_tensor(arrays["init_state"]).to(dtype).expand(B, 5)
    done_prev = torch.zeros(B, dtype=dtype, device=done.device)
    for t in range(steps):
        x, prior_bw, lik, _ = mpf_step(exp, st, x, prior_bw, lik, done_prev,
                                       action[:, t], states[:, t])
        done_prev = done[:, t]
    return x
