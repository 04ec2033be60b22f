"""Scenario sweeps of whole skid-steer navigation DuSt episodes in one launch
(K15): n_sc scenarios (per-scenario true x_icr, wheel radius and axial
distance, crash and goal termination, weighted priors, Silverman
bandwidths and MPF posteriors) times `n_chains` independent episode chains
times G groups, every episode one block of `csrc/skid_steer_episode.cu`,
so each scenario's values equal an independent run of it on the same
draws, and a diverged scenario cannot reach another one. The controller
a_seq is zero (the adapter asserts it, as the particle's does).

`fused_skid_steer_sweep_groups` takes the group axis (the
`MegakernelGroupSweep` path). On CPU tensors it runs the plain version,
`ops.skid_steer_episode.skid_steer_episode_plain`, batched over all
episodes. The kernel keys each episode's draws by (chain seed, step,
scenario index), as the other sweeps do (`ops/sweep_inputs.py:SeedRows`).
"""

from __future__ import annotations

import torch

from .episode_kernel import GuardCounts, run_episodes
from .skid_steer_episode import (
    KERNEL,
    MPF_WIDTH,
    episode_plain,
    episode_statics,
    skid_steer_scal,
)
from .sweep_inputs import InputCache, check_sweep_dims, prepared, run_sweep


def _prepare(runner, seeds_shape, state0, theta0, locs0, log_mix0, a_mat0,
             mpfx0, prior_bw0, true_x_icr, true_wheel_radius,
             true_axial_distance, ctrl_sigma, lr, alpha, temp, prior_sigma,
             mpf_lr, mpf_sigma, *, n_sc, n_chains=1, **statics):
    """The `Prepared` inputs of one argument set of `_sweep_groups`: on
    CUDA tensors the kernel's form (`kernel_statics`), else the plain
    version's."""
    check_sweep_dims("skid-steer sweep kernel", n_sc, statics["hz"],
                     statics["m"], statics["n_params"], statics["n_act"],
                     statics["m_mpf"], width=2, plan_limit=512)
    sp = episode_statics(**statics)
    m, hz, m_mpf = sp["m"], sp["hz"], sp["m_mpf"]
    dev = torch.as_tensor(theta0).device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    G, C = seeds_shape[0], n_chains
    B = G * C * n_sc
    ev = 2 * hz
    ep_f = torch.stack([f32(v).expand(G, n_sc) for v in (
        true_x_icr, true_wheel_radius, true_axial_distance)], dim=-1)
    mpfx0 = f32(mpfx0).reshape(-1, m_mpf, MPF_WIDTH).expand(
        n_sc, m_mpf, MPF_WIDTH)
    per_ep = lambda v: f32(v).reshape(1, m, ev).expand(B, m, ev)
    inputs = dict(
        scal=skid_steer_scal(state0, ctrl_sigma, lr, alpha, temp,
                             prior_sigma, mpf_lr, mpf_sigma, prior_bw0, dev),
        ep_f=ep_f[:, None].expand(G, C, n_sc, MPF_WIDTH).reshape(
            B, MPF_WIDTH),
        log_mix0=f32(log_mix0).reshape(m),
        theta0=per_ep(theta0), locs0=per_ep(locs0), amat0=per_ep(a_mat0),
        mpfx0=mpfx0[None].expand(G * C, n_sc, m_mpf, MPF_WIDTH).reshape(
            B, m_mpf, MPF_WIDTH),
    )
    return prepared(KERNEL, _launch_k15, runner, inputs, sp, seeds_shape, C,
                    n_sc)


def _sweep_groups(runner, seeds, state0, theta0, *args, **kwargs):
    """`fused_skid_steer_sweep_groups`, with the runner of the canonical
    inputs (the kernel or the plain version) first
    (`sweep_inputs.run_sweep`; counted in
    `fused_skid_steer_sweep_groups.input_hits` / `.input_builds`)."""
    return run_sweep(runner, _prepare, _INPUTS,
                     fused_skid_steer_sweep_groups, seeds, state0, theta0,
                     args, kwargs)


def _launch_k15(inputs, sp):
    return run_episodes(fused_skid_steer_sweep_groups, inputs, sp, KERNEL)


def fused_skid_steer_sweep_groups(*args, **kwargs):
    """fused_skid_steer_sweep_groups(seeds, state0, theta0, locs0, log_mix0,
    a_mat0, mpfx0, prior_bw0, true_x_icr, true_wheel_radius,
    true_axial_distance, ctrl_sigma, lr, alpha, temp, prior_sigma, mpf_lr,
    mpf_sigma, *, n_sc, n_chains=1, steps, warm_up=0, hz, m, n_params,
    n_act, m_mpf, mpf_steps, dt, lo, hi, weights, target, rects, grid,
    crash, load_step, load_scale=1.0, success_dist, exp_util=True,
    weighted_prior=True, mpf_log_space=True, mpf_fixed_bw=None,
    mpf_bw_scale=1.0)

    Run G x n_chains x n_sc skid-steer navigation DuSt episodes in one
    launch.

    seeds [G, 2] (chain 0 of each group; chains past the given rows derive
    by +4099*c) or [G, k, 2]; state0 [5] shared initial state (x, y,
    theta, v, omega); theta0/locs0/a_mat0 [m, hz, 2] and log_mix0 [m]
    shared; mpfx0 [m_mpf, 3] shared or [n_sc, m_mpf, 3] per scenario
    ((log-)x_icr, wheel_radius, axial_distance); true_x_icr /
    true_wheel_radius / true_axial_distance [G, n_sc] (or [n_sc], shared),
    x_icr times `load_scale` from step `load_step` on; dt, lo, hi, weights,
    target, rects, grid, crash the model's constants
    (`skid_steer_episode.skid_steer_kernel_statics`).

    Returns per-scenario logs x, y, theta, v, omega, a_r, a_l, cost, done,
    crashed, bw_sv, bw_mpf [G, (n_chains,) steps, n_sc], final
    theta/locs/a_mat [G, (n_chains,) n_sc, m, hz, 2] and MPF particles
    [G, (n_chains,) n_sc, m_mpf, 3] (the chain axis when n_chains > 1). CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_skid_steer_sweep_groups.launches`). A repeat call
    with the same argument objects and new seeds reuses the kernel's
    inputs built by the first (`sweep_inputs.run_sweep` says what
    matches)."""
    return _sweep_groups(_launch_k15, *args, **kwargs)


def plain_skid_steer_sweep_groups(*args, **kwargs):
    """`fused_skid_steer_sweep_groups`'s plain version on the inputs'
    device, with the same arguments (the kernel's reference on the
    card)."""
    return _sweep_groups(episode_plain, *args, **kwargs)


fused_skid_steer_sweep_groups.launches = 0
fused_skid_steer_sweep_groups.mpf_reg_launches = 0
fused_skid_steer_sweep_groups.mpf_smem_launches = 0
# the rollouts' fast and fallback steps (`.fast` / `.fallback`)
fused_skid_steer_sweep_groups.rollout_guard = GuardCounts()
fused_skid_steer_sweep_groups.input_hits = 0
fused_skid_steer_sweep_groups.input_builds = 0
# the prepared inputs of `_sweep_groups` (both runners)
_INPUTS = InputCache()
