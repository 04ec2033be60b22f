"""The cart-pole DuSt episode's work, counted from a cell's shapes, as
`counts.py` counts the pendulum's and the particle's (the sweep's bound,
`counts.least_seconds`, takes them at the card's peaks).

They count the work of the algorithm at the given shapes, whatever
implements it: operations are float32 and integer operations (exp, sin,
cos, a division, a hash step: one each), per episode step; bytes are each
input read once and each output written once.
"""

from __future__ import annotations

# one model step of one trajectory: the swing-up cost of the state 15 (14
# and its add into the trajectory's cost); sin and cos of the angle 2; the
# accelerations 24 (friction 4, the common factor 6, the angle's numerator
# 4, its denominator 5, the angle's acceleration 1, the cart's 4); the
# Euler update of the four values 8
TRAJ_STEP_OPS = 15 + 2 + 24 + 8
# per trajectory: the terminal cost 16 (a cos, 14, the add), the draw's
# constants 4 (total mass, pole mass x length, their reciprocals) and its
# share of the param average 1
TRAJ_OPS = 16 + 4 + 1
# the MPF's likelihood gradient of one particle: the predicted speeds and
# their residuals 26, four reciprocals 4, the derivatives of the factor,
# numerator, denominator and both accelerations 37, the residuals' weights
# and the two gradients 12
LIK_OPS = 26 + 4 + 37 + 12
# the rest of a Stein iteration per particle: the prior score's two
# quotients and terms 6, the drive terms 6, the lane sums and max 14, the
# update of both values 12; per particle pair: the prior score 20, the RBF
# drive 12
MPF_PARTICLE_OPS = 6 + 6 + 14 + 12
MPF_PAIR_OPS = 20 + 12
# per MPF update, the transition's constants (sin, cos, force, friction,
# products and the residual weight)
MPF_UPDATE_OPS = 15
# the simulator: the force 3, the constants 4, sin and cos 2, the
# accelerations 24, the Euler update 8, the new state's cost 15
SIM_OPS = 3 + 4 + 2 + 24 + 8 + 15


def rollout_ops(n_params, m, n_act, hz):
    """The rollouts of one solve: every draw's trajectory of every
    (particle, sample) pair over the horizon, and each (particle, sample,
    step)'s action theta + sigma eps, its clamp and force (5)."""
    return (n_params * m * n_act * (TRAJ_STEP_OPS * hz + TRAJ_OPS)
            + m * n_act * hz * 5)


def solve_ops(n_params, m, n_act, hz):
    """One SVMPC solve inside an episode: the rollouts (`rollout_ops`); the
    delta and likelihood sums (4 per (particle, sample, step)); per
    (particle, sample) the param average and the softmaxes (n_params +
    14); the Stein step and forward as counts.solve_ops counts them: 6
    per particle pair and step for each of three squared distances, 8 per
    pair and step for the score and kernel sums, 8 per particle and
    step."""
    ops = rollout_ops(n_params, m, n_act, hz)
    ops += m * n_act * hz * 4
    ops += m * n_act * (n_params + 14)
    ops += 3 * m * m * hz * 6 + m * m * hz * 8 + m * hz * 8
    return ops


def mpf_ops(m_mpf, mpf_steps):
    """One MPF update: the transition's constants, then per Stein
    iteration the likelihood gradient and the rest per particle and the
    prior score and RBF drive per particle pair."""
    return MPF_UPDATE_OPS + mpf_steps * (
        MPF_PAIR_OPS * m_mpf * m_mpf + (LIK_OPS + MPF_PARTICLE_OPS) * m_mpf)


def step_ops(n_params, m, n_act, hz, m_mpf, mpf_steps):
    """One episode step: the noise (48 per normal for hz m n_act + 2
    n_params normals, 20 per uniform for n_params), the two Silverman
    bandwidths (2 compares per value pair and 4 per value), the draws (8
    each), the solve, the simulator and the MPF update."""
    n_sv, n_mpf = m * hz, 2 * m_mpf
    return (48 * (hz * m * n_act + 2 * n_params) + 20 * n_params
            + 2 * (n_sv * n_sv + n_mpf * n_mpf) + 4 * (n_sv + n_mpf)
            + 8 * n_params + solve_ops(n_params, m, n_act, hz) + SIM_OPS
            + mpf_ops(m_mpf, mpf_steps))


def episodes_bytes(episodes, steps, m, hz, m_mpf):
    """Bytes of `episodes` episodes: per episode the inputs read once
    (shared scalars 14, true parameters 2, seeds 3, theta0 / locs0 /
    a_mat0, the MPF particles) and the outputs written once (8 log values
    per step, theta / locs / a_mat, the MPF particles)."""
    return 4 * episodes * (19 + 3 * m * hz + 2 * m_mpf
                           + 8 * steps + 3 * m * hz + 2 * m_mpf)


def cartpole_work(exp, steps, episodes=1):
    """(operations, bytes) of `episodes` cart-pole DuSt episodes of `steps`
    steps at the shapes of the config's `exp_params`."""
    ops = episodes * steps * step_ops(
        exp["params_samples"], exp["n_particles"], exp["action_samples"],
        exp["horizon"], exp["mpf_n_particles"], exp["mpf_steps"])
    nbytes = episodes_bytes(episodes, steps, exp["n_particles"],
                            exp["horizon"], exp["mpf_n_particles"])
    return ops, nbytes
