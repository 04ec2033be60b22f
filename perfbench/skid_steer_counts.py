"""The skid-steer configuration's work, counted from a cell's shapes: the
operations and bytes of its DuSt episodes, for `mfu_pct` and
`sweep_roofline` (K15's share of its roofline) in `skid_steer.sweep`.

Counted as `counts.py` counts the particle's, whose solve, noise and map
this task shares: float32 and integer operations as the episode kernels
do them (exp, sin, cos, a hash step: one each), each input read once and
each output written once. They count the algorithm's work at the given
shapes, whatever implements it.
"""

from __future__ import annotations

from perfbench.counts import particle_model_floats

# the values of an MPF particle: x_icr, wheel_radius, axial_distance
N_PARAMS = 3


def skid_steer_step_ops():
    """One trajectory step: occupancy 20 (as the particle's); the state cost
    17 over (x, y, v, omega); the control cost 6; the two clamps 4; the
    speeds 8 (v 3, omega 4 and its division 1); the crash factor 2; the
    sine and cosine of the heading 2 and their range test 2; the shifts 4
    (fwd 1, lat 3); the pose 10 (x 4, y 4, theta 2). The terminal cost:
    occupancy and 17. Returns (per step, terminal)."""
    return 75, 37


def skid_steer_solve_ops(n_params, m, n_act, hz):
    """One SVMPC solve inside an episode: every rollout
    (`skid_steer_step_ops`), then the particle's: the param average and
    the softmaxes (n_params + 14 per pair), the actions theta + sigma eps
    and the delta and likelihood sums (7 per (particle, sample, value)),
    the Stein step and forward on rows of hz * 2 values."""
    ev = 2 * hz
    step, term = skid_steer_step_ops()
    ops = n_params * m * n_act * (hz * step + term)
    ops += m * n_act * (n_params + 14)
    ops += m * n_act * ev * 7
    ops += 3 * m * m * ev * 6 + m * m * ev * 8 + m * ev * 8
    return ops


def skid_steer_mpf_ops(m, n_steps):
    """One update of the posterior over three parameters: per iteration,
    per particle the likelihood gradient (~70: three exps, the predicted
    state and its derivatives) and the update (12); per particle pair the
    prior score 18 (the squared distance 8, its scale, max, exp, the
    weight sums 8) and the RBF drive 17 (the squared distance 8, its
    scale, exp, the row and drive sums 7)."""
    return n_steps * (35 * m * m + 82 * m)


def skid_steer_work(exp, env, steps, mpf_updates, episodes=1):
    """(operations, bytes) of `episodes` skid-steer DuSt episodes of
    `steps` steps in which the MPF ran `mpf_updates` updates in all (it
    skips the steps after an episode ends): per episode and step the
    solve, the noise (48 per normal for 2 hz m n_act + 3 n_params
    normals, 20 per uniform), the Silverman rank count over the m hz 2
    policy values, the draws (8 and an exp per value, one reciprocal), the
    simulator, cost and termination (~100); `skid_steer_mpf_ops` per
    update. Bytes: per episode the inputs read once (the model array, 14
    scalars, 3 true parameters, seeds, log-weights, theta / locs / a_mat,
    the MPF particles) and the outputs written once (12 log values per
    step, theta / locs / a_mat, the MPF particles)."""
    n_params, m = exp["params_samples"], exp["n_particles"]
    n_act, hz = exp["action_samples"], exp["horizon"]
    m_mpf = exp["mpf_n_particles"]
    ev = 2 * hz
    n_sv = m * ev
    n_normals = 2 * hz * m * n_act + N_PARAMS * n_params
    per_step = (skid_steer_solve_ops(n_params, m, n_act, hz)
                + 48 * n_normals + 20 * n_params
                + 2 * n_sv * n_sv + 4 * n_sv
                + n_params * (9 * N_PARAMS + 1) + 100)
    ops = (episodes * steps * per_step
           + mpf_updates * skid_steer_mpf_ops(m_mpf, exp["mpf_steps"]))
    nbytes = episodes * 4 * (particle_model_floats(env) + 14 + N_PARAMS + 3
                             + m + 3 * m * ev + N_PARAMS * m_mpf
                             + 12 * steps + 3 * m * ev + N_PARAMS * m_mpf)
    return ops, nbytes
