"""The algorithm's work, counted from a cell's shapes, and the card's peaks.

Frozen copies of the operation and byte counts that the port's kernel
checks use (`_solve_ops`, `_episode_ops`, `_episodes_bound`,
`_particle_solve_ops`, `_k7_ops`, `_k9_bound` and `_particle_step_ops`
of the repository's `chip_smoke.py`, as of this benchmark's first
version). They count the work of the DuSt algorithm at the given shapes,
whatever implements it, so a later change that splits, fuses or removes a
kernel leaves them as they are. Operations are float32 and integer
operations as the episode kernels do them (exp, sin, a hash step: one
each); bytes are each input read once and each output written once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM published peaks (data sheet, dense, 700 W): float32
# outside the tensor cores, and HBM3 bandwidth
PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12


def least_seconds(nbytes, ops):
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory peak. Returns
    (seconds, "operations" or "bytes")."""
    t_ops = ops / PEAK_F32_OPS_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# -- the pendulum ---------------------------------------------------------------


def solve_ops(n_params, m, n_act, hz):
    """One pendulum SVMPC solve inside an episode: per trajectory and
    rollout step 34 (cost 6, dynamics 7, angle 1, the rotation polynomials
    13, the rotation 6) plus 10 per trajectory (terminal cost 6,
    coefficients 4); per (particle, sample, step) the actions theta +
    sigma eps and their clamp (4) and the delta / likelihood sums (4); per
    (particle, sample) the param average and the softmaxes
    (n_params + 14); the Stein step and forward: 6 per particle pair and
    step for each of the three squared distances, 8 per pair and step for
    the score and kernel sums, 8 per particle and step."""
    ops = n_params * m * n_act * (34 * hz + 10)
    ops += m * n_act * hz * (4 + 4)
    ops += m * n_act * (n_params + 14)
    ops += 3 * m * m * hz * 6 + m * m * hz * 8 + m * hz * 8
    return ops


def episode_ops(steps, n_params, m, n_act, hz, m_mpf, mpf_steps):
    """One pendulum DuSt episode, per step: the solve (`solve_ops`); the
    noise, 48 per normal for hz*m*n_act + 2*n_params
    normals and 20 per uniform for n_params; the two Silverman bandwidths,
    2 compares per value pair and 4 per value; the MPF loop, per iteration
    28 per particle pair and 57 per particle; the draws (8 per draw) and
    the simulator (20)."""
    n_sv, n_mpf = m * hz, 2 * m_mpf
    per_step = (solve_ops(n_params, m, n_act, hz)
                + 48 * (hz * m * n_act + 2 * n_params) + 20 * n_params
                + 2 * (n_sv * n_sv + n_mpf * n_mpf) + 4 * (n_sv + n_mpf)
                + mpf_steps * (28 * m_mpf * m_mpf + 57 * m_mpf)
                + 8 * n_params + 20)
    return steps * per_step


def episodes_bytes(episodes, steps, m, hz, m_mpf):
    """Bytes of `episodes` pendulum episodes: per episode the inputs read
    once (shared scalars 12, true parameters 2, seeds 3, theta0 / locs0 /
    a_mat0, the MPF particles) and the outputs written once (6 log values
    per step, theta / locs / a_mat, the MPF particles)."""
    return 4 * episodes * (17 + 3 * m * hz + 2 * m_mpf
                           + 6 * steps + 3 * m * hz + 2 * m_mpf)


def pendulum_work(exp, steps, episodes=1):
    """(operations, bytes) of `episodes` pendulum DuSt episodes of `steps`
    steps at the shapes of the config's `exp_params`."""
    shape = dict(n_params=exp["params_samples"], m=exp["n_particles"],
                 n_act=exp["action_samples"], hz=exp["horizon"])
    ops = episodes * episode_ops(steps, m_mpf=exp["mpf_n_particles"],
                                 mpf_steps=exp["mpf_steps"], **shape)
    nbytes = episodes_bytes(episodes, steps, exp["n_particles"],
                            exp["horizon"], exp["mpf_n_particles"])
    return ops, nbytes


# -- the particle -----------------------------------------------------------------


def particle_step_ops():
    """One trajectory step: occupancy 20 (two scaled floors, four clamp
    compares, two NaN tests, the cell index, the bit lookup); the state
    cost 17, the control cost 6, the accelerations 6, the freeze factor 2,
    the position 4, the velocity 8. The terminal cost: occupancy and 17.
    Returns (per step, terminal)."""
    return 63, 37


def particle_solve_ops(n_params, m, n_act, hz):
    """One particle SVMPC solve inside an episode: every rollout
    (`particle_step_ops`), the param average and the softmaxes
    (n_params + 14 per pair), the actions theta + sigma eps and the delta
    and likelihood sums (7 per (particle, sample, value)), the Stein step
    and forward as `solve_ops` counts them on rows of hz * 2 values."""
    ev = 2 * hz
    step, term = particle_step_ops()
    ops = n_params * m * n_act * (hz * step + term)
    ops += m * n_act * (n_params + 14)
    ops += m * n_act * ev * 7
    ops += 3 * m * m * ev * 6 + m * m * ev * 8 + m * ev * 8
    return ops


def particle_mpf_ops(m, n_steps):
    """One mass-posterior update: per iteration, per particle the
    likelihood gradient (~36 with the log-space exp and factor) and the
    update (~8); per particle pair the prior score 14 and the RBF drive
    8."""
    return n_steps * (22 * m * m + 44 * m)


def particle_model_floats(env):
    """Floats of the particle kernels' model array: a 26-value header and
    the map's occupancy as one bit per cell in 32-bit words."""
    nx = math.ceil(env["map_size"][0] / env["map_cell_size"])
    ny = math.ceil(env["map_size"][1] / env["map_cell_size"])
    return 26 + -(-nx * ny // 32)


def particle_work(exp, env, steps, mpf_updates, episodes=1):
    """(operations, bytes) of `episodes` particle DuSt episodes of `steps`
    steps in which the MPF ran `mpf_updates` updates in all (it skips the
    steps after an episode ends): per episode and step the solve, the
    noise (48 per normal for 2 hz m n_act + n_params normals,
    20 per uniform), the Silverman rank count over the m hz 2 policy
    values, the draws (8 each), the simulator, cost and termination
    (~80); `particle_mpf_ops` per update. Bytes: per episode the inputs
    read once (model, 15 scalars, base mass, seeds, log-weights, theta /
    locs / a_mat, a_seq, the MPF particles) and the outputs written once
    (12 log values per step, theta / locs / a_mat, the MPF particles, the
    final prior log-weights)."""
    n_params, m = exp["params_samples"], exp["n_particles"]
    n_act, hz = exp["action_samples"], exp["horizon"]
    m_mpf = exp["mpf_n_particles"]
    ev = 2 * hz
    n_sv = m * ev
    n_normals = 2 * hz * m * n_act + n_params
    per_step = (particle_solve_ops(n_params, m, n_act, hz)
                + 48 * n_normals + 20 * n_params
                + 2 * n_sv * n_sv + 4 * n_sv + 8 * n_params + 80)
    ops = (episodes * steps * per_step
           + mpf_updates * particle_mpf_ops(m_mpf, exp["mpf_steps"]))
    nbytes = episodes * 4 * (particle_model_floats(env) + 15 + 1 + 3 + m
                             + 3 * m * ev + ev + m_mpf + 12 * steps
                             + 3 * m * ev + m_mpf + m)
    return ops, nbytes
