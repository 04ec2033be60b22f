"""The whole particle-navigation DuSt episode in one launch (K9):
counterpart of `dust_tpu/ops/pallas_particle_episode.py`.

`steps` iterations of

  noise -> dynamics draws from the live MPF prior (log-mass, exp() into
  mass space) -> Silverman bandwidth of the policy particles -> the SVMPC
  solve (K8's body: all n_params x m x n_act rollouts with rectangle
  collisions, DISCO update, Stein step, selection, roll) -> warm-up gate
  of the action, the particles and the weighted-prior refresh ->
  simulator step with the true mass (+load from `change_at`), crash
  freeze, state frozen once done -> MPF mass-posterior update (K7's
  body), gated on t >= warm_up and not done -> cost, crash and success
  detection -> one log row

run as one program. Each step's log row holds (px, py, vx, vy, a_x, a_y,
cost, done, crashed, cum, bw_sv, bw_mpf).

Noise has two modes, as in the pendulum episode (`ops/episode.py`):

* host-noise mode (the parity path): `host_eps [steps, 2, hz, 8, 128]`,
  `host_pdz`/`host_pdu [steps, 8, 128]` in the JAX layout (rows q < m
  and lanes i < n_act of the action noise, lane 0 of rows p < n_params
  of the draws);
* device-RNG mode: the counter-based lowbias32 stream of `ops/episode.py`
  keyed by (seed[0], seed[1], step, scenario); draw indices per step:
  action normals ((c * hz + t) * m + q) * n_act + i, then mass normals
  n_eps + p, then uniforms at uniform index 2 * (n_eps + n_params) + p.
  It equals the TPU stream in distribution only; the plain version
  reproduces it.

* On CUDA tensors `fused_particle_episode` launches the hand-written
  kernel `csrc/particle_episode.cu` (which replaces the TPU kernel
  `dust_tpu/ops/pallas_particle_episode.py:fused_particle_episode`): one
  persistent block per episode (the launch: `K9` on
  `ops/episode_kernel.py:run_episodes`).
* On CPU tensors it runs `particle_episode_plain`, the same arithmetic in
  plain PyTorch, batched over episodes.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch

from .episode import (
    _normals_at,
    bits_to_uniform,
    counter_bits,
    rng_key,
    silverman_rows,
)
from .episode_kernel import EpisodeKernel, run_episodes
from .phase_clock import PhaseClock

LOG_FIELDS = ("px", "py", "vx", "vy", "a_x", "a_y", "cost", "done",
              "crashed", "cum", "bw_sv", "bw_mpf")
# the phases of one step that the kernel's clocked build times, in order
# (csrc/particle_episode.cu, kClkNoise ... kClkTail)
CLOCK_PHASES = ("noise", "silverman", "draws", "rollouts", "disco_weights",
                "disco_delta", "stein_forward", "commit_simulator",
                "mpf_bandwidth", "mpf_loop", "cost_log")
# `with phase_clock() as rows:` launches the clocked build
phase_clock = PhaseClock(CLOCK_PHASES)
# lanes that share one entry's sum over the action samples in the kernel's
# DISCO delta (csrc/particle_episode.cu:kSumLanes)
SUM_LANES = 8


def particle_device_noise(seeds, scenario, step, hz, m, n_act, n_params):
    """One step's draws of the device-RNG mode. seeds [B, 2], scenario [B]
    (int64 tensors). Returns eps [B, 2, hz, m, n_act], pdz [B, n_params],
    pdu [B, n_params]."""
    dev = seeds.device
    key = rng_key(seeds[:, 0], seeds[:, 1], step, scenario).reshape(-1, 1)
    n_eps = 2 * hz * m * n_act
    eps = _normals_at(key, torch.arange(n_eps, device=dev)).reshape(
        -1, 2, hz, m, n_act)
    pdz = _normals_at(key, n_eps + torch.arange(n_params, device=dev))
    pdu = bits_to_uniform(counter_bits(
        key, 2 * (n_eps + n_params) + torch.arange(n_params, device=dev)))
    return eps, pdz, pdu


def episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma, load,
                 mpf_lr, mpf_sigma, prior_bw0, mpf_fixed_bw, device):
    """[px0, py0, vx0, vy0, ctrl_sigma, lr, alpha, inv_temp, inv_s2,
    inv_ps2, load, mpf_lr, mpf_sigma, prior_bw0, mpf_fixed_bw] as one
    float32 tensor on `device`."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).reshape(-1)

    return torch.cat([
        f(state0)[:4], f(ctrl_sigma), f(lr), f(alpha), 1.0 / f(temp),
        1.0 / f(ctrl_sigma) ** 2, 1.0 / f(prior_sigma) ** 2, f(load),
        f(mpf_lr), f(mpf_sigma), f(prior_bw0), f(mpf_fixed_bw),
    ])


def particle_episode_plain(scal, base_mass, seeds, scenario, log_mix0,
                           theta0, locs0, amat0, a_seq, mpfx0, eps=None,
                           pdz=None, pdu=None, *, st, steps, warm_up,
                           n_params, n_act, mpf_steps, change_at,
                           success_dist, exp_util, weighted_prior,
                           mpf_log_space, use_fixed_mpf_bw, mpf_bw_scale):
    """Plain PyTorch version of the kernel over B independent episodes.

    scal [15] as built by `episode_scal`; base_mass [B] the simulator's
    true mass before the load; seeds [B, 2], scenario [B] int64
    (device-RNG mode); log_mix0 [m]; theta0/locs0/amat0 [B, m, hz * 2];
    a_seq [hz * 2]; mpfx0 [B, m_mpf]; st the rollout statics
    (`particle_rollout.rollout_costs`). Host-noise mode passes eps
    [B, steps, 2, hz, m, n_act], pdz/pdu [B, steps, n_params]. Returns
    (log [B, steps, 12], theta, locs, a_mat [B, m, hz * 2], mpf_x
    [B, m_mpf], the final prior log-weights [B, m])."""
    from .particle_mpf import lane_sum, particle_mpf_optimize_plain
    from .particle_rollout import occupancy
    from .solve import disco_weights, particle_rollout_mcost, stein_forward

    (px0, py0, vx0, vy0, sigma_c, lr, alpha, inv_temp, inv_s2, inv_ps2,
     load, mpf_lr, mpf_sigma, prior_bw0, fixed_bw) = scal.unbind()
    B, m, ev = theta0.shape
    hz = ev // 2
    m_mpf = mpfx0.shape[1]
    dev = theta0.device
    (w_px, w_py, w_vx, w_vy, _, _, w_obs, _, _, _, _) = st["weights"]
    tx, ty, tvx, tvy = st["target"]
    rects, grid = st["rects"], st["grid"]
    dt, max_acc, max_speed = st["dt"], st["max_acc"], st["max_speed"]
    crash = st["crash"] and rects is not None
    zero = torch.zeros(B, device=dev)

    def occ(px, py):
        return zero if rects is None else occupancy(px, py, rects, grid)

    theta, locs, amat, x = theta0, locs0, amat0, mpfx0
    logmix = log_mix0.expand(B, m)
    s = [v.expand(B) for v in (px0, py0, vx0, vy0)]  # simulator state
    lik = list(s)                                       # MPF lik.loc
    prior_bw = prior_bw0.expand(B)
    done, crashed, cum = zero, zero, zero
    logs = []
    for t in range(steps):
        if eps is None:
            eps_t, pdz_t, pdu_t = particle_device_noise(
                seeds, scenario, t, hz, m, n_act, n_params)
        else:
            eps_t, pdz_t, pdu_t = eps[:, t], pdz[:, t], pdu[:, t]

        bw_sv = silverman_rows(theta.reshape(B, m * ev))
        # dynamics draws from the live MPF prior
        idx = torch.clamp(torch.floor(pdu_t * float(m_mpf)),
                          max=float(m_mpf - 1)).long()
        draws = torch.gather(x, 1, idx) + prior_bw[:, None] * pdz_t
        if mpf_log_space:
            draws = torch.exp(draws)
        im = 1.0 / draws

        def act(tt):
            a_x = theta[:, :, 2 * tt, None] + sigma_c * eps_t[:, 0, tt]
            a_y = theta[:, :, 2 * tt + 1, None] + sigma_c * eps_t[:, 1, tt]
            return a_x[:, None], a_y[:, None]

        mcost = particle_rollout_mcost(torch.stack(s, dim=-1), act, im, st)
        omega, _, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                               exp_util)
        # every action as [B, m, n_act, hz * 2]
        acts = theta[:, :, None, :] + sigma_c * eps_t.permute(
            0, 3, 4, 2, 1).reshape(B, m, n_act, ev)
        # the sums over the samples in the kernel's order
        delta = lane_sum((omega[..., None] * (acts - a_seq)).transpose(2, 3),
                         SUM_LANES)[..., 0]
        wa = lane_sum((w_lik[..., None] * acts).transpose(2, 3),
                      SUM_LANES)[..., 0]
        glik = (wa - theta) * inv_s2
        theta_new, theta_fwd, weights, a_sel = stein_forward(
            theta, locs, glik, logmix, bw_sv, lr, inv_ps2, log_l, dim_a=2)

        # warm-up gate: no action, keep the optimized particles and prior
        active = 1.0 if t >= warm_up else 0.0
        a_x, a_y = active * a_sel[:, 0], active * a_sel[:, 1]
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

        # simulator: the model with the true mass, crash freeze, frozen
        # once done
        sim_mass = base_mass + load if t >= change_at else base_mass
        spx, spy, svx, svy = s
        s_scale = dt * (1.0 - occ(spx, spy)) if crash else dt
        acc_x = torch.clamp(a_x / sim_mass, -max_acc, max_acc)
        acc_y = torch.clamp(a_y / sim_mass, -max_acc, max_acc)
        frozen = done > 0.5
        new = (spx + svx * s_scale, spy + svy * s_scale,
               torch.clamp(svx + acc_x * s_scale, -max_speed, max_speed),
               torch.clamp(svy + acc_y * s_scale, -max_speed, max_speed))
        npx, npy, nvx, nvy = (torch.where(frozen, o, n)
                              for o, n in zip(s, new))

        # MPF mass-posterior update, gated on t >= warm_up and not done
        gate = (active * (1.0 - done)) > 0.5
        if use_fixed_mpf_bw:
            bw_mpf = fixed_bw.expand(B)
        else:
            bw_mpf = silverman_rows(x) * mpf_bw_scale
        mscale = dt * (1.0 - occ(lik[0], lik[1])) if crash else \
            torch.full((B,), dt, device=dev)
        mscal = torch.stack([
            bw_mpf, prior_bw, mpf_lr.expand(B), mpf_sigma.expand(B),
            lik[2], lik[3], a_x, a_y, nvx, nvy, mscale], dim=-1)
        x_new = particle_mpf_optimize_plain(
            x[..., None], x[..., None], mscal, n_steps=mpf_steps,
            max_acc=max_acc, max_speed=max_speed,
            log_space=mpf_log_space)[..., 0]
        x = torch.where(gate[:, None], x_new, x)
        prior_bw = torch.where(gate, bw_mpf, prior_bw)
        lik = [torch.where(gate, n, o)
               for o, n in zip(lik, (npx, npy, nvx, nvy))]

        # cost, then crash / goal detection against the pre-step done
        occ_n = occ(npx, npy)
        cost_t = (w_px * (npx - tx) ** 2 + w_py * (npy - ty) ** 2
                  + w_vx * (nvx - tvx) ** 2 + w_vy * (nvy - tvy) ** 2
                  + w_obs * occ_n)
        cum = cum + (1.0 - done) * cost_t
        crash_now = occ_n > 0.0
        dist2 = ((tx - npx) ** 2 + (ty - npy) ** 2 + (tvx - nvx) ** 2
                 + (tvy - nvy) ** 2)
        success_now = dist2 <= success_dist * success_dist
        crashed = torch.maximum(crashed,
                                (crash_now & (done < 0.5)).to(torch.float32))
        done = torch.maximum(done, (crash_now | success_now).to(torch.float32))
        logs.append(torch.stack([npx, npy, nvx, nvy, a_x, a_y, cost_t, done,
                                 crashed, cum, bw_sv, bw_mpf], dim=-1))
        s = [npx, npy, nvx, nvy]
    return torch.stack(logs, dim=1), theta, locs, amat, x, logmix


# -- launch -------------------------------------------------------------------


def episode_plain(inputs, sp):
    """The plain version on canonical inputs (see
    `episode_kernel.run_episodes`), on the device they lie on."""
    return particle_episode_plain(
        **inputs, **{k: v for k, v in sp.items()
                     if k not in ("m", "hz", "m_mpf")})


def _model(sp, device):
    """The kernel's model array, from the rollout statics."""
    from .particle_rollout import model_tensor

    st = sp["st"]
    return {"model": model_tensor(st, st["dt"], st["max_acc"],
                                  st["max_speed"], device)}


def _scalars(sp):
    return (
        sp["steps"], sp["warm_up"], sp["hz"], sp["m"], sp["n_params"],
        sp["n_act"], sp["m_mpf"], sp["mpf_steps"], sp["change_at"],
        float(sp["success_dist"]) * float(sp["success_dist"]),
        math.log(float(sp["n_act"])), int(sp["exp_util"]),
        int(sp["weighted_prior"]), int(sp["mpf_log_space"]),
        int(sp["use_fixed_mpf_bw"]), float(sp["mpf_bw_scale"]),
    )


# K9 for `episode_kernel.run_episodes`: a plan holds (a_x, a_y) per
# horizon step, an MPF particle one log-mass; the final log-mix output is
# not written
K9 = EpisodeKernel(
    entry="dust_particle_episodes",
    # looked up at each call, so that a test can swap the module's
    plain=lambda inputs, sp: episode_plain(inputs, sp),
    log_fields=LOG_FIELDS, clock=phase_clock,
    pointers=("model", "scal", "base_mass", "ep_i", "log_mix0", "theta0",
              "locs0", "amat0", "a_seq", "mpfx0"),
    host_noise=True, scalars=_scalars, operands=_model, plan_width=2,
    mpf_width=1, log_mix=False)
# K10: the same entry, writing each episode's final prior log-weights
K10 = replace(K9, log_mix=True)


def episode_statics(*, steps, warm_up=0, hz, m, n_params, n_act, m_mpf,
                    mpf_steps, dt, max_acc, max_speed, weights, target, rects,
                    grid, crash, success_dist=1.0, change_at, exp_util=True,
                    weighted_prior=True, mpf_log_space=True,
                    use_fixed_mpf_bw=True, mpf_bw_scale=1.0):
    """The kernel's limits, checked, and its statics as `K9` and `K10`
    take them."""
    from .particle_rollout import _statics

    if hz * 2 > 128 or n_act > 128 or m > 8:
        raise ValueError("particle episode kernel: hz*2<=128, n_act<=128, "
                         "m<=8")
    if m_mpf > 64:
        raise ValueError("particle episode kernel: m_mpf <= 64")
    if n_params > 8:
        raise ValueError("particle episode kernel: n_params <= 8")
    st = _statics(hz, dt, max_acc, max_speed, weights, target, rects, grid,
                  crash)
    return dict(st=st, steps=int(steps), warm_up=int(warm_up), hz=int(hz),
                m=int(m), m_mpf=int(m_mpf), n_params=int(n_params),
                n_act=int(n_act), mpf_steps=int(mpf_steps),
                change_at=int(change_at), success_dist=float(success_dist),
                exp_util=bool(exp_util), weighted_prior=bool(weighted_prior),
                mpf_log_space=bool(mpf_log_space),
                use_fixed_mpf_bw=bool(use_fixed_mpf_bw),
                mpf_bw_scale=float(mpf_bw_scale))


def _episode(runner, seed, state0, theta0, locs0, log_mix0, a_mat0, a_seq0,
             mpfx0, prior_bw0, base_mass, load, ctrl_sigma, lr, alpha, temp,
             prior_sigma, mpf_lr, mpf_sigma, mpf_fixed_bw_val, *,
             host_eps=None, host_pdz=None, host_pdu=None, **statics):
    """`fused_particle_episode`, with the runner of the canonical inputs
    (the kernel or the plain version) first."""
    sp = episode_statics(**statics)
    m, hz, m_mpf = sp["m"], sp["hz"], sp["m_mpf"]
    n_params, n_act = sp["n_params"], sp["n_act"]
    dev = torch.as_tensor(theta0).device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    ev = 2 * hz
    inputs = dict(
        scal=episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma,
                          load, mpf_lr, mpf_sigma, prior_bw0,
                          mpf_fixed_bw_val, dev),
        base_mass=f32(base_mass).reshape(1),
        seeds=torch.as_tensor(seed, dtype=torch.int64,
                              device=dev).reshape(1, 2),
        scenario=torch.zeros((1,), dtype=torch.int64, device=dev),
        log_mix0=f32(log_mix0).reshape(m),
        theta0=f32(theta0).reshape(1, m, ev),
        locs0=f32(locs0).reshape(1, m, ev),
        amat0=f32(a_mat0).reshape(1, m, ev),
        a_seq=f32(a_seq0).reshape(ev),
        mpfx0=f32(mpfx0).reshape(1, m_mpf),
        eps=None, pdz=None, pdu=None,
    )
    if host_eps is not None:
        inputs["eps"] = f32(host_eps)[:, :, :, :m, :n_act][None]
        inputs["pdz"] = f32(host_pdz)[:, :n_params, 0][None]
        inputs["pdu"] = f32(host_pdu)[:, :n_params, 0][None]
    log, theta, locs, amat, mpf_x, _ = runner(inputs, sp)
    log = log[0]
    out = {"state": log[:, 0:4], "action": log[:, 4:6],
           **{k: log[:, i] for i, k in enumerate(LOG_FIELDS) if i >= 6}}
    out.update(theta=theta[0].reshape(m, hz, 2),
               locs=locs[0].reshape(m, hz, 2),
               a_mat=amat[0].reshape(m, hz, 2),
               mpf_x=mpf_x[0].reshape(m_mpf, 1))
    return out


def _launch_k9(inputs, sp):
    return run_episodes(fused_particle_episode, inputs, sp, K9)


def fused_particle_episode(*args, **kwargs):
    """fused_particle_episode(seed, state0, theta0, locs0, log_mix0, a_mat0,
    a_seq0, mpfx0, prior_bw0, base_mass, load, ctrl_sigma, lr, alpha,
    temp, prior_sigma, mpf_lr, mpf_sigma, mpf_fixed_bw_val, *, steps,
    warm_up=0, hz, m, n_params, n_act, m_mpf, mpf_steps, dt, max_acc,
    max_speed, weights, target, rects, grid, crash, success_dist=1.0,
    change_at, exp_util=True, weighted_prior=True, mpf_log_space=True,
    use_fixed_mpf_bw=True, mpf_bw_scale=1.0, host_eps=None, host_pdz=None,
    host_pdu=None)

    Run one whole particle-navigation DuSt episode.

    seed int [2] (device-RNG mode; ignored in host-noise mode); state0 [4];
    theta0/locs0/a_mat0 [m, hz, 2]; log_mix0 [m] normalized prior mixture
    log-weights; a_seq0 [hz, 2]; mpfx0 [m_mpf, 1] (log-)mass particles;
    base_mass the simulator's true mass before the +load change at
    `change_at`; the model's statics as
    `particle_rollout.particle_kernel_statics` returns them.

    Returns a dict: state [steps, 4], action [steps, 2], cost, done,
    crashed, cum, bw_sv, bw_mpf [steps], final theta/locs/a_mat
    [m, hz, 2], mpf_x [m_mpf, 1]. CPU tensors take the plain version;
    CUDA tensors launch the kernel (counted in
    `fused_particle_episode.launches`, and by the MPF loop it takes in
    `.mpf_reg_launches` / `.mpf_smem_launches`)."""
    return _episode(_launch_k9, *args, **kwargs)


fused_particle_episode.launches = 0
fused_particle_episode.mpf_reg_launches = 0
fused_particle_episode.mpf_smem_launches = 0


def plain_particle_episode(*args, **kwargs):
    """`fused_particle_episode`'s plain version on the inputs' device, with
    the same arguments (the kernel's reference on the card)."""
    return _episode(episode_plain, *args, **kwargs)
