"""Scenario sweeps of whole pendulum DuSt episodes in one launch (K5):
counterpart of `dust_tpu/ops/pallas_sweep_episode.py:
fused_pendulum_sweep_episode`.

n_sc scenarios (per-scenario true parameters, Silverman bandwidths and
MPF posteriors) times `n_chains` independent episode chains advance in one
program. The TPU kernel packs scenarios into tile rows and lane halves;
here every (group, chain, scenario) episode is one block of the
whole-episode kernel (`csrc/pendulum_episode.cu`, the entry K4 launches
too), so each scenario's values equal an
independent `fused_pendulum_episode` run on the same draws, and a diverged
scenario cannot reach another one. The controller a_seq term is dropped
(the adapter asserts a_seq == 0, as the TPU kernel does).

`fused_pendulum_sweep_groups` folds a leading group axis G into the same
launch (the `MegakernelGroupSweep` path); `fused_pendulum_sweep_episode`
is its G = 1 case. On CPU tensors both run the plain version,
`ops.episode.pendulum_episode_plain`, batched over all episodes.

Device-RNG mode keys each episode's draws by (chain seed, step, scenario
index); the TPU stream is equal in distribution only.
"""

from __future__ import annotations

import torch

from .episode import (
    episode_plain,
    episode_scal,
    episode_statics,
    run_episodes,
    split_log,
)

_LAYOUTS = ("colbcast", "lanepack", "symm")
# the TPU kernel's chain-seed stride (`pallas_sweep_episode.py:1376-1392`)
_CHAIN_SEED_STRIDE = 4099


def _round8(n):
    return -(-n // 8) * 8


def check_sweep_dims(n_sc, hz, m, n_params, n_act, m_mpf, mpf_drive_layout,
                     probe_skip):
    """The TPU adapter's limits, kept as coded
    (`pallas_sweep_episode.py:1345-1371`)."""
    if n_sc > 16:
        raise ValueError("sweep episode kernel: n_sc <= 16 per program "
                         "(batch larger sweeps on the group axis)")
    if mpf_drive_layout not in _LAYOUTS:
        raise ValueError("sweep episode kernel: mpf_drive_layout must "
                         "be 'colbcast', 'lanepack' or 'symm'")
    if tuple(probe_skip) != ():
        raise ValueError("sweep episode kernel: probe_skip is a TPU "
                         "attribution probe; only () is supported")
    if hz > 128 or n_act > 128:
        raise ValueError("sweep episode kernel: hz<=128, n_act<=128")
    if n_params > 8:
        raise ValueError("sweep episode kernel: n_params <= 8")
    if m * hz > 128:
        raise ValueError("sweep episode kernel: m*hz <= 128")
    if _round8(max(m_mpf, 8)) > 64:
        raise ValueError("sweep episode kernel: m_mpf <= 64")


def chain_seeds(seeds, n_chains):
    """seeds [G, 2] or [G, k, 2] -> [G, n_chains, 2] int64: rows past the
    given ones derive from row 0 as +4099*c on the second word."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64)
    if seeds.ndim == 2:
        seeds = seeds[:, None]
    k = seeds.shape[1]
    if k < n_chains:
        extra = torch.stack([
            seeds[:, 0] + torch.tensor([0, _CHAIN_SEED_STRIDE * c],
                                       device=seeds.device)
            for c in range(k, n_chains)], dim=1)
        seeds = torch.cat([seeds, extra], dim=1)
    return seeds[:, :n_chains]


def _host_noise(host_eps, host_pdz, host_pdu, G, C, n_sc, steps, hz, m,
                n_params, n_act, dev):
    """JAX-layout host noise with a leading group axis (and a chain axis
    when C > 1) -> canonical per-episode tensors, episode b = (g*C + c)*n_sc
    + s: eps [B, steps, hz, m, n_act], pdz [B, steps, n_params, 2],
    pdu [B, steps, n_params]."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    sm = n_sc * m
    eps = f32(host_eps).reshape(G, C, steps, hz, -1, 128)[..., :sm, :n_act]
    eps = eps.reshape(G, C, steps, hz, n_sc, m, n_act).permute(
        0, 1, 4, 2, 3, 5, 6).reshape(-1, steps, hz, m, n_act)
    pdz = f32(host_pdz).reshape(G, C, steps, n_sc, 8, 128)[..., :n_params, :2]
    pdz = pdz.permute(0, 1, 3, 2, 4, 5).reshape(-1, steps, n_params, 2)
    pdu = f32(host_pdu).reshape(G, C, steps, n_sc, 8, 128)[..., :n_params, 0]
    pdu = pdu.permute(0, 1, 3, 2, 4).reshape(-1, steps, n_params)
    return eps, pdz, pdu


def _sweep_groups(
        runner, seeds, state0, theta0, locs0, a_mat0, mpfx0, prior_bw0,
        true_lengths, true_masses, ctrl_sigma, lr, alpha, temp,
        prior_sigma, mpf_lr, mpf_sigma, *, n_sc, steps, warm_up=0, hz,
        m, n_params, n_act, m_mpf, mpf_steps, dt=0.05, g_model=9.8,
        g_sim=10.0, exp_util=True, mpf_log_space=False,
        mpf_fixed_bw=None, mpf_bw_scale=1.0, unroll=True,
        host_eps=None, host_pdz=None, host_pdu=None,
        mpf_drive_layout="colbcast", probe_skip=(), n_chains=1):
    """`fused_pendulum_sweep_groups`, with the runner of the canonical
    inputs (the kernel or the plain version) first."""
    check_sweep_dims(n_sc, hz, m, n_params, n_act, m_mpf, mpf_drive_layout,
                     probe_skip)
    dev = torch.as_tensor(theta0).device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    seeds = chain_seeds(torch.as_tensor(seeds, device=dev), n_chains)
    G, C = seeds.shape[0], n_chains
    B = G * C * n_sc
    st = episode_statics(steps, warm_up, hz, m, n_params, n_act, m_mpf,
                         mpf_steps, dt, g_model, g_sim, exp_util,
                         mpf_log_space, mpf_fixed_bw, mpf_bw_scale)
    lens = f32(true_lengths).expand(G, n_sc)
    mass = f32(true_masses).expand(G, n_sc)
    ep_f = torch.stack([1.0 / lens, 1.0 / mass], dim=-1)     # [G, n_sc, 2]
    mpfx0 = f32(mpfx0)
    mpfx0 = mpfx0.reshape(-1, m_mpf, 2).expand(n_sc, m_mpf, 2)
    per_ep = lambda v: f32(v).reshape(1, m, hz).expand(B, m, hz)
    inputs = dict(
        scal=episode_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma,
                          mpf_lr, mpf_sigma, prior_bw0, m, dev),
        ep_f=ep_f[:, None].expand(G, C, n_sc, 2).reshape(B, 2),
        seeds=seeds[:, :, None].expand(G, C, n_sc, 2).reshape(B, 2),
        scenario=torch.arange(n_sc, device=dev).repeat(G * C),
        theta0=per_ep(theta0), locs0=per_ep(locs0), amat0=per_ep(a_mat0),
        a_seq=None,
        mpfx0=mpfx0[None].expand(G * C, n_sc, m_mpf, 2).reshape(
            B, m_mpf, 2),
        eps=None, pdz=None, pdu=None,
    )
    if host_eps is not None:
        inputs["eps"], inputs["pdz"], inputs["pdu"] = _host_noise(
            host_eps, host_pdz, host_pdu, G, C, n_sc, steps, hz, m,
            n_params, n_act, dev)
    log, theta, locs, amat, mpf_x = runner(inputs, st)
    lead = (G, C) if n_chains > 1 else (G,)
    out = {k: v.reshape(*lead, n_sc, steps).transpose(-1, -2)
           for k, v in split_log(log).items()}
    out.update(
        theta=theta.reshape(*lead, n_sc, m, hz),
        locs=locs.reshape(*lead, n_sc, m, hz),
        a_mat=amat.reshape(*lead, n_sc, m, hz),
        mpf_x=mpf_x.reshape(*lead, n_sc, m_mpf, 2),
    )
    return out


def _launch_k5(inputs, st):
    return run_episodes(fused_pendulum_sweep_episode, inputs, st)


def fused_pendulum_sweep_groups(*args, **kwargs):
    """fused_pendulum_sweep_groups(seeds, *same arguments as
    fused_pendulum_sweep_episode after the seed*)

    G sweep groups in one launch. seeds [G, 2] or [G, k, 2];
    true_lengths/true_masses [G, n_sc] (or [n_sc], shared); host noise,
    when given, with a leading G axis (then the chain axis when
    n_chains > 1) before the layout of `fused_pendulum_sweep_episode`.
    Returns that function's dict with a leading G axis.
    Counted in `fused_pendulum_sweep_episode.launches`."""
    return _sweep_groups(_launch_k5, *args, **kwargs)


def plain_pendulum_sweep_groups(*args, **kwargs):
    """`fused_pendulum_sweep_groups`'s plain version on the inputs' device,
    with the same arguments (the kernel's reference on the card)."""
    return _sweep_groups(episode_plain, *args, **kwargs)


def fused_pendulum_sweep_episode(
        seed, state0, theta0, locs0, a_mat0, mpfx0, prior_bw0,
        true_lengths, true_masses, ctrl_sigma, lr, alpha, temp,
        prior_sigma, mpf_lr, mpf_sigma, *, n_sc, steps, warm_up=0, hz,
        m, n_params, n_act, m_mpf, mpf_steps, dt=0.05, g_model=9.8,
        g_sim=10.0, exp_util=True, mpf_log_space=False,
        mpf_fixed_bw=None, mpf_bw_scale=1.0, unroll=True,
        host_eps=None, host_pdz=None, host_pdu=None,
        mpf_drive_layout="colbcast", probe_skip=(), n_chains=1):
    """Run n_sc x n_chains pendulum DuSt episodes in one launch.

    seed [2] (chain 0; chains past the given rows derive by +4099*c) or
    [k, 2]; state0 [2] shared initial state; theta0/locs0/a_mat0 [m, hz]
    shared across scenarios; mpfx0 [m_mpf, 2] shared or [n_sc, m_mpf, 2]
    per scenario; true_lengths/true_masses [n_sc]. The controller a_seq
    is zero. `unroll` and `mpf_drive_layout` select TPU loop forms and
    change no value (the layout is validated); `probe_skip` must be ().

    Host-noise mode: host_eps [steps, hz, smp, 128] (rows s*m + q,
    smp = n_sc*m rounded up to 8), host_pdz/host_pdu [steps, n_sc, 8, 128],
    each with a leading chain axis when n_chains > 1.

    Returns per-scenario logs cost/th/om/action/bw_sv/bw_mpf
    [steps, n_sc], final theta/locs/a_mat [n_sc, m, hz] and MPF particles
    [n_sc, m_mpf, 2], with a leading chain axis when n_chains > 1. CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_pendulum_sweep_episode.launches`)."""
    noise = {k: (None if v is None else torch.as_tensor(v)[None])
             for k, v in (("host_eps", host_eps), ("host_pdz", host_pdz),
                          ("host_pdu", host_pdu))}
    out = fused_pendulum_sweep_groups(
        torch.as_tensor(seed)[None], state0, theta0, locs0, a_mat0, mpfx0,
        prior_bw0, torch.as_tensor(true_lengths)[None],
        torch.as_tensor(true_masses)[None], ctrl_sigma, lr, alpha, temp,
        prior_sigma, mpf_lr, mpf_sigma, n_sc=n_sc, steps=steps,
        warm_up=warm_up, hz=hz, m=m, n_params=n_params, n_act=n_act,
        m_mpf=m_mpf, mpf_steps=mpf_steps, dt=dt, g_model=g_model,
        g_sim=g_sim, exp_util=exp_util, mpf_log_space=mpf_log_space,
        mpf_fixed_bw=mpf_fixed_bw, mpf_bw_scale=mpf_bw_scale, unroll=unroll,
        mpf_drive_layout=mpf_drive_layout, probe_skip=probe_skip,
        n_chains=n_chains, **noise)
    return {k: v[0] for k, v in out.items()}


fused_pendulum_sweep_episode.launches = 0
