"""Scenario sweeps of whole particle-navigation DuSt episodes in one launch
(K10): counterpart of `dust_tpu/ops/pallas_particle_sweep_episode.py:
fused_particle_sweep_episode`.

n_sc scenarios (per-scenario true simulator masses, seeds, crash and goal
termination, weighted priors, bandwidths and MPF mass posteriors) times
`n_chains` independent episode chains advance in one program. The TPU
kernel packs scenarios into tile rows and lane halves; here every
(group, chain, scenario) episode is one block of the whole-episode kernel
(`csrc/particle_episode.cu`, the entry K9 launches too, which here also
writes each episode's final prior log-weights), so each scenario's values
equal an independent `fused_particle_episode` run on the same draws, and a
diverged scenario cannot reach another one. The controller a_seq is fixed
at zero, as in the TPU kernel.

`fused_particle_sweep_groups` folds a leading group axis G into the same
launch (the `MegakernelGroupSweep` path); `fused_particle_sweep_episode` is
its G = 1 case. On CPU tensors both run the plain version,
`ops.particle_episode.particle_episode_plain`, batched over all episodes.

Device-RNG mode keys each episode's draws by (chain seed, step, scenario
index); the TPU stream is equal in distribution only.
"""

from __future__ import annotations

import torch

from .particle_episode import (
    LOG_FIELDS,
    episode_plain,
    episode_scal,
    episode_statics,
    run_particle_episodes,
)
from .sweep_episode import _round8, chain_seeds


def check_particle_sweep_dims(n_sc, hz, m, n_params, n_act, m_mpf,
                              probe_skip):
    """The TPU adapter's limits, kept as coded
    (`pallas_particle_sweep_episode.py:1176-1200`)."""
    if n_sc > 16:
        raise ValueError("particle sweep kernel: n_sc <= 16 per program "
                         "(batch larger sweeps on the group axis)")
    if hz * 2 > 128 or n_act > 128:
        raise ValueError("particle sweep kernel: hz*2<=128, n_act<=128")
    if n_params > 8:
        raise ValueError("particle sweep kernel: n_params <= 8")
    if m * hz * 2 > 512:
        raise ValueError("particle sweep kernel: m*hz*2 <= 512")
    if _round8(max(m_mpf, 8)) > 64:
        raise ValueError("particle sweep kernel: m_mpf <= 64")
    if tuple(probe_skip) != ():
        raise ValueError("particle sweep kernel: probe_skip is a TPU "
                         "attribution probe; only () is supported")


def _host_noise(host_eps, host_pdz, host_pdu, G, C, n_sc, steps, hz, m,
                n_params, n_act, dev):
    """JAX-layout host noise with a leading group axis (and a chain axis
    when C > 1) -> K9's per-episode tensors, episode b = (g*C + c)*n_sc + s:
    eps [B, steps, 2, hz, m, n_act], pdz/pdu [B, steps, n_params]."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    sm = n_sc * m
    eps = f32(host_eps).reshape(G, C, steps, hz, 2, -1, 128)[..., :sm, :n_act]
    eps = eps.reshape(G, C, steps, hz, 2, n_sc, m, n_act).permute(
        0, 1, 5, 2, 4, 3, 6, 7).reshape(-1, steps, 2, hz, m, n_act)

    def draws(v):
        v = f32(v).reshape(G, C, steps, n_sc, 8, 128)[..., :n_params, 0]
        return v.permute(0, 1, 3, 2, 4).reshape(-1, steps, n_params)

    return eps, draws(host_pdz), draws(host_pdu)


def _sweep_groups(
        runner, seeds, state0, theta0, locs0, log_mix0, a_mat0, mpfx0,
        prior_bw0, true_masses, load, ctrl_sigma, lr, alpha, temp,
        prior_sigma, mpf_lr, mpf_sigma, mpf_fixed_bw_val, *, n_sc,
        host_eps=None, host_pdz=None, host_pdu=None, probe_skip=(),
        n_chains=1, **statics):
    """`fused_particle_sweep_groups`, with the runner of the canonical
    inputs (the kernel or the plain version) first."""
    check_particle_sweep_dims(n_sc, statics["hz"], statics["m"],
                              statics["n_params"], statics["n_act"],
                              statics["m_mpf"], probe_skip)
    sp = episode_statics(**statics)
    steps, hz, m, m_mpf = sp["steps"], sp["hz"], sp["m"], sp["m_mpf"]
    dev = torch.as_tensor(theta0).device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    seeds = chain_seeds(torch.as_tensor(seeds, device=dev), n_chains)
    G, C = seeds.shape[0], n_chains
    B = G * C * n_sc
    ev = 2 * hz
    mass = f32(true_masses).expand(G, n_sc)
    mpfx0 = f32(mpfx0).reshape(-1, m_mpf).expand(n_sc, m_mpf)
    per_ep = lambda v: f32(v).reshape(1, m, ev).expand(B, m, ev)
    inputs = dict(
        scal=episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma,
                          load, mpf_lr, mpf_sigma, prior_bw0,
                          mpf_fixed_bw_val, dev),
        base_mass=mass[:, None].expand(G, C, n_sc).reshape(B),
        seeds=seeds[:, :, None].expand(G, C, n_sc, 2).reshape(B, 2),
        scenario=torch.arange(n_sc, device=dev).repeat(G * C),
        log_mix0=f32(log_mix0).reshape(m),
        theta0=per_ep(theta0), locs0=per_ep(locs0), amat0=per_ep(a_mat0),
        a_seq=torch.zeros((ev,), device=dev),
        mpfx0=mpfx0[None].expand(G * C, n_sc, m_mpf).reshape(B, m_mpf),
        eps=None, pdz=None, pdu=None,
    )
    if host_eps is not None:
        inputs["eps"], inputs["pdz"], inputs["pdu"] = _host_noise(
            host_eps, host_pdz, host_pdu, G, C, n_sc, steps, hz, m,
            sp["n_params"], sp["n_act"], dev)
    log, theta, locs, amat, mpf_x, logmix = runner(inputs, sp)
    lead = (G, C) if n_chains > 1 else (G,)
    log = log.reshape(*lead, n_sc, steps, len(LOG_FIELDS))
    out = {k: log[..., i].transpose(-1, -2)
           for i, k in enumerate(LOG_FIELDS)}
    out.update(
        theta=theta.reshape(*lead, n_sc, m, hz, 2),
        locs=locs.reshape(*lead, n_sc, m, hz, 2),
        a_mat=amat.reshape(*lead, n_sc, m, hz, 2),
        log_mix=logmix.reshape(*lead, n_sc, m),
        mpf_x=mpf_x.reshape(*lead, n_sc, m_mpf, 1),
    )
    return out


def _launch_k10(inputs, sp):
    return run_particle_episodes(fused_particle_sweep_episode, inputs, sp,
                                 log_mix=True)


def fused_particle_sweep_groups(*args, **kwargs):
    """fused_particle_sweep_groups(seeds, *same arguments as
    fused_particle_sweep_episode after the seed*)

    G sweep groups in one launch. seeds [G, 2] or [G, k, 2]; true_masses
    [G, n_sc] (or [n_sc], shared); host noise, when given, with a leading G
    axis (then the chain axis when n_chains > 1) before the layout of
    `fused_particle_sweep_episode`. Returns that function's dict with a
    leading G axis. Counted in `fused_particle_sweep_episode.launches`."""
    return _sweep_groups(_launch_k10, *args, **kwargs)


def plain_particle_sweep_groups(*args, **kwargs):
    """`fused_particle_sweep_groups`'s plain version on the inputs' device,
    with the same arguments (the kernel's reference on the card)."""
    return _sweep_groups(episode_plain, *args, **kwargs)


def fused_particle_sweep_episode(
        seed, state0, theta0, locs0, log_mix0, a_mat0, mpfx0, prior_bw0,
        true_masses, load, ctrl_sigma, lr, alpha, temp, prior_sigma, mpf_lr,
        mpf_sigma, mpf_fixed_bw_val, *, host_eps=None, host_pdz=None,
        host_pdu=None, **kwargs):
    """fused_particle_sweep_episode(seed, state0, theta0, locs0, log_mix0,
    a_mat0, mpfx0, prior_bw0, true_masses, load, ctrl_sigma, lr, alpha,
    temp, prior_sigma, mpf_lr, mpf_sigma, mpf_fixed_bw_val, *, n_sc, steps,
    warm_up=0, hz, m, n_params, n_act, m_mpf, mpf_steps, dt, max_acc,
    max_speed, weights, target, rects, grid, crash, success_dist=1.0,
    change_at, exp_util=True, weighted_prior=True, mpf_log_space=True,
    use_fixed_mpf_bw=True, mpf_bw_scale=1.0, host_eps=None, host_pdz=None,
    host_pdu=None, probe_skip=(), n_chains=1)

    Run n_sc x n_chains particle-navigation DuSt episodes in one launch.

    seed [2] (chain 0; chains past the given rows derive by +4099*c) or
    [k, 2]; state0 [4] shared; theta0/locs0/a_mat0 [m, hz, 2] and log_mix0
    [m] shared across scenarios; mpfx0 [m_mpf, 1] shared or
    [n_sc, m_mpf, 1] per scenario; true_masses [n_sc] the simulator's base
    masses (+`load` for every scenario from `change_at`). The controller
    a_seq is zero. `probe_skip` must be ().

    Host-noise mode: host_eps [steps, hz, 2, smp, 128] (channel x/y, rows
    s*m + q; smp = n_sc*m rounded up to 8), host_pdz/host_pdu
    [steps, n_sc, 8, 128] (lane 0 of rows p < n_params), each with a
    leading chain axis when n_chains > 1.

    Returns per-scenario logs px, py, vx, vy, a_x, a_y, cost, done,
    crashed, cum, bw_sv, bw_mpf [steps, n_sc], final theta/locs/a_mat
    [n_sc, m, hz, 2], log_mix [n_sc, m] and MPF particles [n_sc, m_mpf, 1],
    with a leading chain axis when n_chains > 1. CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    `fused_particle_sweep_episode.launches`)."""
    noise = {k: (None if v is None else torch.as_tensor(v)[None])
             for k, v in (("host_eps", host_eps), ("host_pdz", host_pdz),
                          ("host_pdu", host_pdu))}
    out = fused_particle_sweep_groups(
        torch.as_tensor(seed)[None], state0, theta0, locs0, log_mix0, a_mat0,
        mpfx0, prior_bw0, torch.as_tensor(true_masses)[None], load,
        ctrl_sigma, lr, alpha, temp, prior_sigma, mpf_lr, mpf_sigma,
        mpf_fixed_bw_val, **noise, **kwargs)
    return {k: v[0] for k, v in out.items()}


fused_particle_sweep_episode.launches = 0
