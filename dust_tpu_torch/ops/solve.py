"""The whole SVMPC solve in one launch, pendulum (K3) and particle
navigation (K8): counterpart of `dust_tpu/ops/pallas_solve.py`
(`_solve_tail`, `_pendulum_solve_kernel`, `_particle_solve_kernel`,
`_check_dims`, `_solve_scal`, `fused_pendulum_solve`,
`fused_particle_solve`).

The particle solve (`fused_particle_solve`, kernel
`csrc/particle_solve.cu`, a thread-block cluster of one block per policy
particle) runs all n_params x m x n_act point-mass rollouts with rectangle
collisions (`particle_rollout.rollout_costs`'s arithmetic), then the same
tail as the pendulum's on particles of hz * 2 values: DISCO weights, Stein
step with the (weighted) mixture log-weights, forward, and the "repeat"
roll by one step of two values.

One solve: all n_params x m x n_act pendulum rollouts (the rollout state
is (cos th, sin th, om), advanced by plane rotation with `rot_sincos`) ->
param-averaged costs -> DISCO softmax weights and the a_mat / a_mix update
-> analytic likelihood gradient, GMM prior score, RBF Stein direction and
SGD step -> posterior weights, first-argmax selection and the "repeat"
horizon roll. Action noise, parameter draws and the Silverman bandwidth
come in as inputs. Semantics = `SVMPC(kernel="rbf",
reference_compat=False, roll_strategy="repeat", n_steps=1)` over a
`MultiDisco` with a_reg == 0 and an isotropic policy prior.

* On CUDA tensors `fused_pendulum_solve` launches the hand-written kernel
  `csrc/pendulum_solve.cu` (which replaces the TPU kernel
  `dust_tpu/ops/pallas_solve.py:fused_pendulum_solve`): a thread-block
  cluster of one block per policy particle, as the particle solve's,
  bound by the latency of its dependent phases, not by bytes or
  arithmetic.
* On CPU tensors it runs `pendulum_solve_plain`, the same arithmetic in
  plain PyTorch.

The pieces after the rollout (`rollout_mcost`, `disco_weights`,
`stein_forward`) are batched over a leading episode axis and shared with
the whole-episode plain version (`ops/episode.py`).
"""

from __future__ import annotations

import math

import torch

from .episode import rot_sincos
from .phase_clock import PhaseClock

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
_SWINGUP_W = 50.0
# the phases of a solve that the clocked builds of K3 and K8 time, in
# order (csrc/pendulum_solve.cu and csrc/particle_solve.cu, kClkLoad ...
# kClkOutputs)
CLOCK_PHASES = ("load", "rollouts", "disco_weights", "disco_delta",
                "stein_forward", "outputs")
# `with phase_clock() as rows:` launches K8's clocked build
phase_clock = PhaseClock(CLOCK_PHASES)
# `with pendulum_phase_clock() as rows:` launches K3's clocked build
pendulum_phase_clock = PhaseClock(CLOCK_PHASES)
# lanes that share one entry's sum over the action samples in K3's and
# K8's delta (csrc/pendulum_solve.cu, csrc/particle_solve.cu: kSumLanes)
SUM_LANES = 8


def check_dims(hz, m, n_act, dim_a=1):
    """The solve's shape ceilings (`pallas_solve.py:_check_dims`)."""
    if n_act > 128:
        raise ValueError("fused solve supports n_actions <= 128")
    if m > 8:
        raise ValueError("fused solve supports n_particles <= 8")
    if hz * dim_a > 128:
        raise ValueError("fused solve supports horizon * ctrl_dim <= 128")


# -- plain pieces, batched over a leading episode axis B ---------------------


def rollout_mcost(th0, om0, acts, il, im, dt, g):
    """Param-averaged swing-up costs of every rollout. th0/om0 [B];
    acts [B, hz, m, n_act] (unclipped); il/im [B, n_params] (1/length,
    1/mass). Returns mcost [B, m, n_act]."""
    n_params = il.shape[1]
    hz = acts.shape[1]
    il = il[:, :, None, None]
    im = im[:, :, None, None]
    c_grav = (-3.0 * g * 0.5 * dt) * il
    c_act = (3.0 * dt) * im * il * il
    shape = (acts.shape[0], n_params) + tuple(acts.shape[2:])
    zs = torch.zeros(shape, dtype=acts.dtype, device=acts.device)
    th = th0.reshape(-1, 1, 1, 1)
    c = zs + torch.cos(th)
    s = zs + torch.sin(th)
    om = zs + om0.reshape(-1, 1, 1, 1)
    cost = zs
    xmax = _MAX_SPEED * dt
    for t in range(hz):
        cost = cost + _SWINGUP_W * (c - 1.0) ** 2 + om * om
        a = torch.clamp(acts[:, t].unsqueeze(1), -_MAX_TORQUE, _MAX_TORQUE)
        om = om + c_grav * (-s) + c_act * a
        om = torch.clamp(om, -_MAX_SPEED, _MAX_SPEED)
        sd, cd = rot_sincos(om * dt, xmax)
        c, s = c * cd - s * sd, s * cd + c * sd
    cost = cost + _SWINGUP_W * (c - 1.0) ** 2 + om * om
    mcost = cost[:, 0]
    for p in range(1, n_params):
        mcost = mcost + cost[:, p]
    return mcost * (1.0 / n_params)


def disco_weights(mcost, inv_temp, alpha, exp_util):
    """DISCO softmax weights and the likelihood's per-particle softmax and
    log-likelihood (`disco.py:348-394`, `svmpc.py:46-56`). mcost
    [B, m, n_act]. Returns (omega, eta [B, m, 1], w_lik, log_l [B, m, 1])."""
    n_act = mcost.shape[-1]
    beta = mcost.amin(dim=(-2, -1), keepdim=True)
    lc = -(mcost - beta) * inv_temp
    row_max = lc.amax(dim=-1, keepdim=True)
    e = torch.exp(lc - row_max)
    sum_e = e.sum(dim=-1, keepdim=True)
    eta = row_max + torch.log(sum_e)
    omega = e / sum_e
    wl = -mcost * alpha
    wl_max = wl.amax(dim=-1, keepdim=True)
    we = torch.exp(wl - wl_max)
    we_sum = we.sum(dim=-1, keepdim=True)
    w_lik = we / we_sum
    if exp_util:
        log_l = wl_max + torch.log(we_sum) - math.log(float(n_act))
    else:
        log_l = -alpha * mcost.sum(dim=-1, keepdim=True) * (1.0 / n_act)
    return omega, eta, w_lik, log_l


def _prior_logits(theta, locs, log_mix, neg_half_ips2, lanes=None):
    """[B, m(q), m(c)] GMM component log-probs (+ mixture log-weights);
    with `lanes`, each squared distance summed over the horizon in the
    order of a group of that many kernel lanes (`lane_sum`)."""
    from .particle_mpf import lane_sum

    m = theta.shape[1]
    cols = []
    for c in range(m):
        diff = theta - locs[:, c:c + 1]
        lm = log_mix if log_mix.ndim < 2 else log_mix[:, c:c + 1, None]
        d2 = (diff * diff).sum(dim=-1, keepdim=True) if lanes is None \
            else lane_sum(diff * diff, lanes)
        cols.append(neg_half_ips2 * d2 + lm)
    return torch.cat(cols, dim=-1)


def stein_forward(theta, locs, glik, log_mix, bw, lr, inv_ps2, log_l,
                  dim_a=1, new_lanes=None):
    """Stein direction + SGD step, then the forward pass (weights,
    first-argmax selection, "repeat" roll by one step of `dim_a` values).
    theta/locs/glik [B, m, hz * dim_a] (the horizon flattened); log_mix a
    scalar or [B, m]; bw [B]; log_l [B, m, 1]; new_lanes: the new
    particles' logits sum over the horizon in the order of that many
    kernel lanes (K3's). Returns (theta_new, theta_fwd [B, m, hz * dim_a],
    weights [B, m], a_seq_sel [B, hz * dim_a])."""
    m = theta.shape[1]
    bw = bw.reshape(-1, 1, 1)
    inv_bw2 = 1.0 / (bw * bw)
    inv_2bw2 = 0.5 * inv_bw2
    neg_half_ips2 = -0.5 * inv_ps2

    lp_pri = _prior_logits(theta, locs, log_mix, neg_half_ips2)
    r_e = torch.exp(lp_pri - lp_pri.amax(dim=-1, keepdim=True))
    r = r_e / r_e.sum(dim=-1, keepdim=True)
    score = glik
    for c in range(m):
        score = score + r[:, :, c:c + 1] * (locs[:, c:c + 1] - theta) \
            * inv_ps2

    kcols = []
    for c in range(m):
        diff = theta - theta[:, c:c + 1]
        kcols.append(torch.exp(-inv_2bw2 * (diff * diff).sum(dim=-1,
                                                           keepdim=True)))
    kmat = torch.cat(kcols, dim=-1)                          # [B, m, m]
    k_score = torch.zeros_like(theta)
    k_theta = torch.zeros_like(theta)
    for c in range(m):
        k_score = k_score + kmat[:, :, c:c + 1] * score[:, c:c + 1]
        k_theta = k_theta + kmat[:, :, c:c + 1] * theta[:, c:c + 1]
    rowsum_k = kmat.sum(dim=-1, keepdim=True)
    grad_k = -(k_theta - rowsum_k * theta) * inv_bw2
    phi = (k_score + grad_k) * (1.0 / m)
    theta_new = theta + lr * phi

    lp_new = _prior_logits(theta_new, locs, log_mix, neg_half_ips2,
                           new_lanes)
    n_max = lp_new.amax(dim=-1, keepdim=True)
    log_p = n_max + torch.log(torch.exp(lp_new - n_max).sum(dim=-1,
                                                          keepdim=True))
    log_w = (log_l + log_p)[..., 0]                         # [B, m]
    w_max = log_w.amax(dim=-1, keepdim=True)
    w_e = torch.exp(log_w - w_max)
    weights = w_e / w_e.sum(dim=-1, keepdim=True)
    # first argmax; no row at the max (NaN weights) selects zeros
    rows = torch.arange(m, device=theta.device)
    i_star = torch.where(log_w >= w_max, rows, m).amin(dim=-1)
    a_seq_sel = torch.where(
        (i_star < m)[:, None],
        theta_new[torch.arange(theta.shape[0], device=theta.device),
                  i_star.clamp(max=m - 1)],
        0.0)
    theta_fwd = torch.cat([theta_new[..., dim_a:], theta_new[..., -dim_a:]],
                          dim=-1)
    return theta_new, theta_fwd, weights, a_seq_sel


def _solve_scal(state0, bw, lr, alpha, temp, ctrl_sigma, prior_sigma,
                device, dim_s):
    """[state0 (dim_s values), bw, lr, alpha, temp, ctrl_sigma,
    prior_sigma] as one float32 tensor on `device`: the values as they
    come, gathered by one concatenation (the kernels K3 and K8 and their
    plain versions take the reciprocals themselves, so the call launches
    no arithmetic of its own; the mixture log-weights travel as their own
    tensor)."""
    def f(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=device).reshape(-1)

    return torch.cat([f(state0)[:dim_s], *(f(v) for v in (
        bw, lr, alpha, temp, ctrl_sigma, prior_sigma))])


def pendulum_solve_plain(scal, theta, locs, log_mix, a_mat, a_seq, actions,
                         lengths, masses, dt=0.05, g=9.8, exp_util=True):
    """Plain PyTorch version of the kernel. scal as built by `_solve_scal`
    with dim_s=2; theta/locs/a_mat [m, hz]; log_mix [m]; a_seq [hz];
    actions [n_act, m, hz]; lengths/masses [n_params]. Returns the 7
    outputs of `fused_pendulum_solve`. The delta's and the likelihood
    gradient's sums over the samples, and the new particles' logits' sums
    over the horizon, take the kernel's order (`lane_sum` over SUM_LANES
    lanes)."""
    from .particle_mpf import lane_sum

    th0, om0, bw, lr, alpha, temp, ctrl_sigma, prior_sigma = scal.unbind()
    inv_temp = 1.0 / temp
    inv_s2 = 1.0 / ctrl_sigma ** 2
    inv_ps2 = 1.0 / prior_sigma ** 2
    acts = actions.permute(2, 1, 0).unsqueeze(0)            # [1, hz, m, n_act]
    mcost = rollout_mcost(th0.reshape(1), om0.reshape(1), acts,
                          (1.0 / lengths).reshape(1, -1),
                          (1.0 / masses).reshape(1, -1), dt, g)
    omega, eta, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                             exp_util)
    # delta_q = sum_i omega[q, i] (a[i, q, :] - a_seq); the likelihood
    # gradient (sum_i w[q, i] a[i, q, :] - theta_q) / sigma^2
    a_qti = actions.permute(1, 2, 0)                        # [m, hz, n_act]
    delta = lane_sum(omega[0, :, None] * (a_qti - a_seq[:, None]),
                     SUM_LANES)[..., 0]
    wa = lane_sum(w_lik[0, :, None] * a_qti, SUM_LANES)[..., 0]
    glik = (wa - theta) * inv_s2
    eta_e = torch.exp(eta - eta.amax(dim=-2, keepdim=True))
    a_mix = (eta_e / eta_e.sum(dim=-2, keepdim=True))[0, :, 0]
    theta_new, theta_fwd, weights, a_seq_sel = stein_forward(
        theta[None], locs[None], glik[None], log_mix[None], bw.reshape(1),
        lr, inv_ps2, log_l, new_lanes=SUM_LANES)
    return (theta_new[0], theta_fwd[0], a_mat + delta, a_mix, a_seq_sel[0],
            weights[0], mcost[0].T)


def fused_pendulum_solve(state0, theta, locs, log_mix, a_mat, a_seq, actions,
                         lengths, masses, bw, lr, alpha, temp, ctrl_sigma,
                         prior_sigma, *, hz, m, n_params, n_act, dt=0.05,
                         g=9.8, exp_util=True):
    """One full pendulum SVMPC solve.

    state0 [2]; theta/locs/a_mat [m, hz] (ctrl_dim 1 squeezed); log_mix
    [m] normalized prior mixture log-weights; a_seq [hz]; actions
    [n_act, m, hz] (sampled, reparameterized); lengths/masses [n_params];
    bw, lr, alpha, temp, ctrl_sigma, prior_sigma scalars (numbers or
    tensors). Returns (theta_opt [m, hz], theta_fwd [m, hz], a_mat_new
    [m, hz], a_mix [m], a_seq_sel [hz], weights [m], costs [n_act, m]).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_pendulum_solve.launches`)."""
    check_dims(hz, m, n_act)
    dev = theta.device
    scal = _solve_scal(state0, bw, lr, alpha, temp, ctrl_sigma, prior_sigma,
                       dev, dim_s=2)
    if tuple(actions.shape) != (n_act, m, hz) or tuple(theta.shape) != (m, hz):
        raise ValueError("expected theta [m, hz] and actions [n_act, m, hz]")
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    locs, log_mix, a_mat, a_seq, actions, lengths, masses = (
        f32(v) for v in (locs, log_mix, a_mat, a_seq, actions, lengths,
                         masses))
    if lengths.shape != (n_params,) or masses.shape != (n_params,):
        raise ValueError("lengths and masses must be [n_params]")
    if dev.type == "cpu":
        return pendulum_solve_plain(scal, theta, locs, log_mix, a_mat, a_seq,
                                    actions, lengths, masses, dt=dt, g=g,
                                    exp_util=exp_util)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n_params > 8:
        raise ValueError("fused solve kernel supports n_params <= 8")
    from ._build import check, load_library

    ins = [t.contiguous() for t in (theta, locs, log_mix, a_mat, a_seq,
                                    actions, lengths, masses)]
    outs = [torch.empty((m, hz), dtype=torch.float32, device=dev)
            for _ in range(3)]
    a_mix = torch.empty((m,), dtype=torch.float32, device=dev)
    a_seq_sel = torch.empty((hz,), dtype=torch.float32, device=dev)
    weights = torch.empty((m,), dtype=torch.float32, device=dev)
    costs = torch.empty((n_act, m), dtype=torch.float32, device=dev)
    args = [scal.data_ptr(), *(t.data_ptr() for t in ins),
            *(t.data_ptr() for t in outs), a_mix.data_ptr(),
            a_seq_sel.data_ptr(), weights.data_ptr(), costs.data_ptr(),
            hz, m, n_params, n_act, float(dt), _MAX_SPEED * dt,
            -3.0 * g * 0.5 * dt, 3.0 * dt, math.log(float(n_act)),
            int(bool(exp_util))]
    clock = pendulum_phase_clock.rows(1, dev)   # block 0's, the whole solve
    stream = torch.cuda.current_stream(dev).cuda_stream
    if clock is None:
        rc = load_library().dust_pendulum_solve(*args, stream)
    else:
        rc = load_library().dust_pendulum_solve_clock(
            *args, clock.data_ptr(), stream)
    fused_pendulum_solve.launches += 1
    check(rc, "pendulum_solve")
    return (outs[0], outs[1], outs[2], a_mix, a_seq_sel, weights, costs)


fused_pendulum_solve.launches = 0


# -- particle navigation (K8) -------------------------------------------------


def particle_rollout_mcost(s0, act, im, st):
    """Param-averaged navigation costs of every rollout. s0 [B, 4]; act(t)
    -> (a_x, a_y) [B, 1, m, n_act]; im [B, n_params] (1/mass); st the
    rollout statics of `particle_rollout.rollout_costs` (with hz).
    Returns mcost [B, m, n_act]."""
    from .particle_rollout import rollout_costs

    B, n_params = im.shape
    a_x, _ = act(0)
    shape = (B, n_params) + tuple(a_x.shape[2:])
    cost = rollout_costs(tuple(s0[:, i].reshape(B, 1, 1, 1)
                               for i in range(4)),
                         act, im[:, :, None, None], shape, st)
    mcost = cost[:, 0]
    for p in range(1, n_params):
        mcost = mcost + cost[:, p]
    return mcost * (1.0 / n_params)


def particle_solve_plain(scal, theta, locs, log_mix, a_mat, a_seq, actions,
                         masses, st, exp_util=True):
    """Plain PyTorch version of the kernel. scal as built by `_solve_scal`
    with dim_s=4; theta/locs/a_mat [m, hz * 2]; log_mix [m]; a_seq
    [hz * 2]; actions [n_act, m, hz, 2]; masses [n_params]; st the rollout
    statics. Returns the 7 outputs of `fused_particle_solve`, horizon
    flattened. The delta's and the likelihood gradient's sums over the
    samples take the kernel's order (`lane_sum` over SUM_LANES lanes)."""
    from .particle_mpf import lane_sum

    s0 = scal[:4]
    bw, lr, alpha, temp, ctrl_sigma, prior_sigma = scal[4:].unbind()
    inv_temp = 1.0 / temp
    inv_s2 = 1.0 / ctrl_sigma ** 2
    inv_ps2 = 1.0 / prior_sigma ** 2
    n_act, m, hz, _ = actions.shape

    def act(t):
        return (actions[:, :, t, 0].T[None, None],
                actions[:, :, t, 1].T[None, None])

    mcost = particle_rollout_mcost(s0[None], act, (1.0 / masses)[None], st)
    omega, eta, w_lik, log_l = disco_weights(mcost, inv_temp, alpha,
                                             exp_util)
    a_qli = actions.reshape(n_act, m, hz * 2).permute(1, 2, 0)
    delta = lane_sum(omega[0, :, None] * (a_qli - a_seq[:, None]),
                     SUM_LANES)[..., 0]
    wa = lane_sum(w_lik[0, :, None] * a_qli, SUM_LANES)[..., 0]
    glik = (wa - theta) * inv_s2
    eta_e = torch.exp(eta - eta.amax(dim=-2, keepdim=True))
    a_mix = (eta_e / eta_e.sum(dim=-2, keepdim=True))[0, :, 0]
    theta_new, theta_fwd, weights, a_seq_sel = stein_forward(
        theta[None], locs[None], glik[None], log_mix[None], bw.reshape(1),
        lr, inv_ps2, log_l, dim_a=2)
    return (theta_new[0], theta_fwd[0], a_mat + delta, a_mix, a_seq_sel[0],
            weights[0], mcost[0].T)


def _particle_solve(plain, state0, theta, locs, log_mix, a_mat, a_seq,
                    actions, masses, bw, lr, alpha, temp, ctrl_sigma,
                    prior_sigma, *, hz, m, n_params, n_act, dt, max_acc,
                    max_speed, weights, target, rects, grid, crash,
                    exp_util=True):
    """`fused_particle_solve`; `plain` runs the plain version on the
    inputs' device."""
    from .particle_rollout import _statics, model_tensor

    check_dims(hz, m, n_act, 2)
    dev = theta.device
    ev = hz * 2
    scal = _solve_scal(state0, bw, lr, alpha, temp, ctrl_sigma, prior_sigma,
                       dev, dim_s=4)
    if tuple(actions.shape) != (n_act, m, hz, 2) or \
            tuple(theta.shape) != (m, hz, 2):
        raise ValueError("expected theta [m, hz, 2] and actions "
                         "[n_act, m, hz, 2]")
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    locs, log_mix, a_mat, a_seq, actions, masses = (
        f32(v) for v in (locs, log_mix, a_mat, a_seq, actions, masses))
    if masses.shape != (n_params,):
        raise ValueError("masses must be [n_params]")
    st = _statics(hz, dt, max_acc, max_speed, weights, target, rects, grid,
                  crash)
    if plain or dev.type == "cpu":
        outs = particle_solve_plain(
            scal, theta.reshape(m, ev), locs.reshape(m, ev), log_mix,
            a_mat.reshape(m, ev), a_seq.reshape(ev), actions, masses, st,
            exp_util=exp_util)
    elif dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    else:
        if n_params > 8:
            raise ValueError("fused solve kernel supports n_params <= 8")
        from ._build import check, load_library

        model = model_tensor(st, dt, max_acc, max_speed, dev)
        ins = [t.contiguous() for t in (theta, locs, log_mix, a_mat, a_seq,
                                        actions, masses)]
        outs = [torch.empty((m, ev), dtype=torch.float32, device=dev)
                for _ in range(3)]
        outs += [torch.empty((m,), dtype=torch.float32, device=dev),
                 torch.empty((ev,), dtype=torch.float32, device=dev),
                 torch.empty((m,), dtype=torch.float32, device=dev),
                 torch.empty((n_act, m), dtype=torch.float32, device=dev)]
        args = [model.data_ptr(), scal.data_ptr(),
                *(t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
                hz, m, n_params, n_act, math.log(float(n_act)),
                int(bool(exp_util))]
        clock = phase_clock.rows(1, dev)   # block 0's, the whole solve
        stream = torch.cuda.current_stream(dev).cuda_stream
        if clock is None:
            rc = load_library().dust_particle_solve(*args, stream)
        else:
            rc = load_library().dust_particle_solve_clock(
                *args, clock.data_ptr(), stream)
        fused_particle_solve.launches += 1
        check(rc, "particle_solve")
    theta_opt, theta_fwd, amat, a_mix, a_seq_sel, w, costs = outs
    return (theta_opt.reshape(m, hz, 2), theta_fwd.reshape(m, hz, 2),
            amat.reshape(m, hz, 2), a_mix, a_seq_sel.reshape(hz, 2), w,
            costs)


def fused_particle_solve(*args, **kwargs):
    """fused_particle_solve(state0, theta, locs, log_mix, a_mat, a_seq,
    actions, masses, bw, lr, alpha, temp, ctrl_sigma, prior_sigma, *, hz,
    m, n_params, n_act, dt, max_acc, max_speed, weights, target, rects,
    grid, crash, exp_util=True)

    One full particle-navigation SVMPC solve.

    state0 [4]; theta/locs/a_mat [m, hz, 2]; log_mix [m] normalized prior
    mixture log-weights; a_seq [hz, 2]; actions [n_act, m, hz, 2]
    (sampled, reparameterized); masses [n_params]; bw, lr, alpha, temp,
    ctrl_sigma, prior_sigma scalars (numbers or tensors); the model's dt,
    limits and statics as `particle_rollout.particle_kernel_statics`
    returns them. Returns (theta_opt [m, hz, 2], theta_fwd [m, hz, 2],
    a_mat_new [m, hz, 2], a_mix [m], a_seq_sel [hz, 2], weights [m], costs
    [n_act, m]).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_particle_solve.launches`)."""
    return _particle_solve(False, *args, **kwargs)


fused_particle_solve.launches = 0


def plain_particle_solve(*args, **kwargs):
    """`fused_particle_solve`'s plain version on the inputs' device, with
    the same arguments (the kernel's reference on the card)."""
    return _particle_solve(True, *args, **kwargs)
