"""Scenario sweeps of whole cart-pole DuSt swing-up episodes in one launch
(K14): n_sc scenarios (per-scenario true length and pole mass, Silverman
bandwidths and MPF posteriors) times `n_chains` independent episode chains
times G groups, every episode one block of `csrc/cartpole_episode.cu`, so
each scenario's values equal an independent run of it on the same draws,
and a diverged scenario cannot reach another one. The controller a_seq is
zero (the adapter asserts it, as the pendulum's does).

`fused_cartpole_sweep_groups` takes the group axis (the
`MegakernelGroupSweep` path). On CPU tensors it runs the plain version,
`ops.cartpole_episode.cartpole_episode_plain`, batched over all episodes.
The kernel keys each episode's draws by (chain seed, step, scenario
index), as the pendulum's sweep does (`ops/sweep_inputs.py:SeedRows`).
"""

from __future__ import annotations

import torch

from .cartpole_episode import (
    KERNEL,
    MODEL_KEYS,
    cartpole_scal,
    episode_plain,
    episode_statics,
)
from .episode_kernel import GuardCounts, run_episodes
from .sweep_inputs import InputCache, check_sweep_dims, prepared, run_sweep


def _prepare(runner, seeds_shape, state0, theta0, locs0, a_mat0, mpfx0,
             prior_bw0, true_lengths, true_mass_poles, ctrl_sigma, lr, alpha,
             temp, prior_sigma, mpf_lr, mpf_sigma, *, n_sc, n_chains=1,
             steps, hz, m, n_params, n_act, m_mpf, mpf_steps,
             dt=0.05, g, mass_cart, mu_c, mu_p, f_mag, load_step=0,
             load_scale=1.0, exp_util=True, mpf_log_space=False,
             mpf_fixed_bw=None, mpf_bw_scale=1.0):
    """The `Prepared` inputs of one argument set of `_sweep_groups`: on
    CUDA tensors the kernel's form (`kernel_statics`), else the plain
    version's."""
    check_sweep_dims("cartpole sweep kernel", n_sc, hz, m, n_params, n_act,
                     m_mpf)
    dev = torch.as_tensor(theta0).device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    G, C = seeds_shape[0], n_chains
    B = G * C * n_sc
    model = dict(zip(MODEL_KEYS, (g, mass_cart, mu_c, mu_p, f_mag)))
    st = episode_statics(steps, hz, m, n_params, n_act, m_mpf, mpf_steps,
                         dt, model, load_step, load_scale, exp_util,
                         mpf_log_space, mpf_fixed_bw, mpf_bw_scale)
    lens = f32(true_lengths).expand(G, n_sc)
    mps = f32(true_mass_poles).expand(G, n_sc)
    ep_f = torch.stack([lens, mps], dim=-1)                   # [G, n_sc, 2]
    mpfx0 = f32(mpfx0).reshape(-1, m_mpf, 2).expand(n_sc, m_mpf, 2)
    per_ep = lambda v: f32(v).reshape(1, m, hz).expand(B, m, hz)
    inputs = dict(
        scal=cartpole_scal(state0, ctrl_sigma, lr, alpha, temp, prior_sigma,
                           mpf_lr, mpf_sigma, prior_bw0, m, dev),
        ep_f=ep_f[:, None].expand(G, C, n_sc, 2).reshape(B, 2),
        theta0=per_ep(theta0), locs0=per_ep(locs0), amat0=per_ep(a_mat0),
        mpfx0=mpfx0[None].expand(G * C, n_sc, m_mpf, 2).reshape(
            B, m_mpf, 2),
    )
    return prepared(KERNEL, _launch_k14, runner, inputs, st, seeds_shape,
                    C, n_sc)


def _sweep_groups(runner, seeds, state0, theta0, *args, **kwargs):
    """`fused_cartpole_sweep_groups`, with the runner of the canonical
    inputs (the kernel or the plain version) first
    (`sweep_inputs.run_sweep`; counted in
    `fused_cartpole_sweep_groups.input_hits` / `.input_builds`)."""
    return run_sweep(runner, _prepare, _INPUTS, fused_cartpole_sweep_groups,
                     seeds, state0, theta0, args, kwargs)


def _launch_k14(inputs, st):
    return run_episodes(fused_cartpole_sweep_groups, inputs, st, KERNEL)


def fused_cartpole_sweep_groups(*args, **kwargs):
    """fused_cartpole_sweep_groups(seeds, state0, theta0, locs0, a_mat0,
    mpfx0, prior_bw0, true_lengths, true_mass_poles, ctrl_sigma, lr,
    alpha, temp, prior_sigma, mpf_lr, mpf_sigma, *, n_sc, n_chains=1,
    steps, hz, m, n_params, n_act, m_mpf, mpf_steps, dt=0.05,
    g, mass_cart, mu_c, mu_p, f_mag, load_step=0, load_scale=1.0,
    exp_util=True, mpf_log_space=False, mpf_fixed_bw=None,
    mpf_bw_scale=1.0)

    Run G x n_chains x n_sc cart-pole DuSt episodes in one launch.

    seeds [G, 2] (chain 0 of each group; chains past the given rows derive
    by +4099*c) or [G, k, 2]; state0 [4] shared initial state (x, x_dot,
    th, th_dot); theta0/locs0/a_mat0 [m, hz] shared; mpfx0 [m_mpf, 2]
    shared or [n_sc, m_mpf, 2] per scenario (length, mass_pole);
    true_lengths / true_mass_poles [G, n_sc] (or [n_sc], shared), the pole
    mass times `load_scale` from step `load_step` on; g ... f_mag the
    model's constants.

    Returns per-scenario logs x, x_dot, th, th_dot, action, cost, bw_sv,
    bw_mpf [G, (n_chains,) steps, n_sc], final theta/locs/a_mat
    [G, (n_chains,) n_sc, m, hz] and MPF particles [G, (n_chains,) n_sc,
    m_mpf, 2] (the chain axis when n_chains > 1). CPU tensors take the
    plain version; CUDA tensors launch the kernel (counted in
    `fused_cartpole_sweep_groups.launches`). A repeat call with the same
    argument objects and new seeds reuses the kernel's inputs built by
    the first, as the pendulum's `fused_pendulum_sweep_groups` does."""
    return _sweep_groups(_launch_k14, *args, **kwargs)


def plain_cartpole_sweep_groups(*args, **kwargs):
    """`fused_cartpole_sweep_groups`'s plain version on the inputs' device,
    with the same arguments (the kernel's reference on the card)."""
    return _sweep_groups(episode_plain, *args, **kwargs)


fused_cartpole_sweep_groups.launches = 0
fused_cartpole_sweep_groups.mpf_reg_launches = 0
fused_cartpole_sweep_groups.mpf_smem_launches = 0
# the rollouts' fast and fallback chunk-steps (`.fast` / `.fallback`)
fused_cartpole_sweep_groups.rollout_guard = GuardCounts()
fused_cartpole_sweep_groups.input_hits = 0
fused_cartpole_sweep_groups.input_builds = 0
# the prepared inputs of `_sweep_groups` (both runners)
_INPUTS = InputCache()
