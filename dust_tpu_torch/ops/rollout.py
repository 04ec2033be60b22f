"""Fused pendulum rollout costs (K1): counterpart of
`dust_tpu/ops/pallas_rollout.py`.

The SVMPC Stein step consumes only per-sequence costs, never the
trajectories. `fused_pendulum_rollout_costs` evolves all n_params x
n_actions x n_pol pendulum trajectories and returns only their swing-up
costs sum_{t<H} inst(s_t) + term(s_H), as [n_params, n_actions, n_pol];
`fused_pendulum_rollout_cost_mean` returns their mean over the draws,
[n_actions, n_pol], which is what the MultiDisco hook
(`make_fused_pendulum_state_costs`) needs.

* On CUDA tensors both launch the hand-written kernel
  `csrc/pendulum_rollout.cu` (which replaces the TPU kernel
  `dust_tpu/ops/pallas_rollout.py:fused_pendulum_rollout_costs`) and
  nothing else: a block per `TRAJ_PER_BLOCK` trajectories with their
  actions staged in shared memory, as many lanes per parameter draw, the
  draws' lengths and masses read through their strides or passed as
  values, the draw mean taken in the same launch. It is bound by its
  H-step dependent chain, not by bytes or arithmetic.
* On CPU tensors they run `pendulum_rollout_costs_plain` (and
  `draw_mean_plain`), the same arithmetic in plain PyTorch, operation by
  operation.

Physics matches `PendulumModel.step` (torque clamp +-2, Euler update,
speed clamp +-8, new-theta_d integration) and the cost matches
`experiments.pendulum_cost_fns` (50 (cos th - 1)^2 + th_dot^2).
"""

from __future__ import annotations

import math

import torch

from ..models.pendulum import PendulumModel
from .phase_clock import PhaseClock

_MAX_SPEED = PendulumModel.MAX_SPEED
_MAX_TORQUE = PendulumModel.MAX_TORQUE
# the swing-up cost weight of `experiments.pendulum_cost_fns`
_SWINGUP_W = 50.0
# trajectories per block of K1 (csrc/pendulum_rollout.cu:kTraj)
TRAJ_PER_BLOCK = 16
# the longest horizon whose actions K1 stages in shared memory
# (csrc/pendulum_rollout.cu:kMaxStagedHz); longer ones it reads from
# device memory
MAX_STAGED_HORIZON = 256
# the phases of K1 that its clocked build times, in order
# (csrc/pendulum_rollout.cu, kClkLoad ... kClkStore)
CLOCK_PHASES = ("load", "rollouts", "store")
# `with phase_clock() as rows:` launches K1's clocked build
phase_clock = PhaseClock(CLOCK_PHASES)


def _swingup(th, om):
    return _SWINGUP_W * (torch.cos(th) - 1.0) ** 2 + om * om


def pendulum_rollout_costs_plain(state0, actions, lengths, masses, dt=0.05,
                                 g=9.8):
    """Plain PyTorch version of the kernel: state0 [2], actions
    [n_actions, n_pol, H, 1], lengths/masses [n_params] (a [1] tensor or
    a number is shared by every draw) -> [n_params, n_actions, n_pol]."""
    lengths, masses = _plain_columns(lengths, masses, actions.device)
    n_act, n_pol, hz, _ = actions.shape
    n_params = lengths.shape[0]
    il = (1.0 / lengths).reshape(n_params, 1, 1)
    im = (1.0 / masses).reshape(n_params, 1, 1)
    c_grav = (-3.0 * g * 0.5 * dt) * il            # dt * (-3g / 2l)
    c_act = 3.0 * dt * im * il * il                # dt * 3 / (m l^2)
    shape = (n_params, n_act, n_pol)
    th = torch.zeros(shape, device=actions.device) + state0[0]
    om = torch.zeros(shape, device=actions.device) + state0[1]
    cost = torch.zeros(shape, device=actions.device)
    for t in range(hz):
        cost = cost + _swingup(th, om)             # charges s_0 .. s_{H-1}
        a = torch.clamp(actions[:, :, t, 0], -_MAX_TORQUE, _MAX_TORQUE)
        om = om + c_grav * torch.sin(th + math.pi) + c_act * a
        om = torch.clamp(om, -_MAX_SPEED, _MAX_SPEED)
        th = th + om * dt                          # new theta_d integration
    return cost + _swingup(th, om)


def draw_mean_plain(costs):
    """The kernel's mean of costs [n_params, ...] over the draws: the
    draws added in order, then multiplied by 1 / n_params (as torch's
    mean scales its sum)."""
    total = torch.zeros_like(costs[0])
    for c in costs:
        total = total + c
    return total * (1.0 / costs.shape[0])


def _n_draws(lengths, masses):
    return max(v.shape[0] if torch.is_tensor(v) else 1
               for v in (lengths, masses))


def _plain_columns(lengths, masses, device):
    """lengths, masses (each a [n] or [1] tensor, or a number) as [n]
    tensors."""
    n = _n_draws(lengths, masses)
    return [torch.as_tensor(v, dtype=torch.float32, device=device)
            .reshape(-1).expand(n) for v in (lengths, masses)]


def _kernel_column(v, device):
    """(ptr, stride, value) of a draw column as K1 reads it: a float32
    tensor on the kernel's device, read where it lies through its stride,
    or a number passed as the value."""
    if not torch.is_tensor(v):
        return 0, 0, float(v)
    if v.dtype != torch.float32 or v.device != device:
        raise ValueError("lengths/masses tensors must be float32 on the "
                         "actions' device")
    return v.data_ptr(), (v.stride(0) if v.shape[0] > 1 else 0), 0.0


def _launch(state0, actions, lengths, masses, dt, g, costs, cost_mean):
    """One launch of K1 writing costs [n_params, n_act, n_pol] or
    cost_mean [n_act, n_pol] (the other is None)."""
    n_act, n_pol, hz, a_dim = actions.shape
    n_params = _n_draws(lengths, masses)
    if (a_dim != 1 or state0.numel() != 2
            or any(torch.is_tensor(v) and (v.dim() != 1 or
                                           v.shape[0] not in (1, n_params))
                   for v in (lengths, masses))):
        raise ValueError(
            "expected state0 [2], actions [n_act, n_pol, H, 1], "
            "lengths/masses [n_params] or [1] or numbers"
        )
    if (actions.dtype != torch.float32 or state0.dtype != torch.float32
            or state0.device != actions.device):
        raise ValueError("state0 and actions must be float32 on one device")
    if n_params * n_act * n_pol == 0 or hz == 0:
        raise ValueError("empty rollout batch")
    from ._build import check, load_library

    cols = [_kernel_column(v, actions.device) for v in (lengths, masses)]
    s0 = state0.reshape(2).contiguous()
    acts = actions.contiguous()
    n_traj = n_act * n_pol
    args = [s0.data_ptr(), acts.data_ptr(), *cols[0], *cols[1],
            0 if costs is None else costs.data_ptr(),
            0 if cost_mean is None else cost_mean.data_ptr(),
            n_params, n_traj, hz, -3.0 * g * 0.5 * dt, 3.0 * dt, dt]
    clock = phase_clock.rows(-(-n_traj // TRAJ_PER_BLOCK), actions.device)
    stream = torch.cuda.current_stream(actions.device).cuda_stream
    if clock is None:
        rc = load_library().dust_pendulum_rollout_costs(*args, stream)
    else:
        rc = load_library().dust_pendulum_rollout_costs_clock(
            *args, clock.data_ptr(), stream)
    fused_pendulum_rollout_costs.launches += 1
    check(rc, "pendulum_rollout_costs")


def fused_pendulum_rollout_costs(state0, actions, lengths, masses, dt=0.05,
                                 g=9.8):
    """State costs of every (param draw, action sample, policy) pendulum
    rollout. state0 [2]; actions [n_actions, n_pol, H, 1] (shared across
    param draws); lengths/masses [n_params] (any stride; [1] or a number
    is shared by every draw). Returns [n_params, n_actions, n_pol].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_pendulum_rollout_costs.launches`)."""
    if actions.device.type == "cpu":
        return pendulum_rollout_costs_plain(state0, actions, lengths, masses,
                                            dt=dt, g=g)
    if actions.device.type != "cuda":
        raise ValueError(f"unsupported device {actions.device}")
    costs = torch.empty((_n_draws(lengths, masses), *actions.shape[:2]),
                        dtype=torch.float32, device=actions.device)
    _launch(state0, actions, lengths, masses, dt, g, costs, None)
    return costs


fused_pendulum_rollout_costs.launches = 0


def fused_pendulum_rollout_cost_mean(state0, actions, lengths, masses,
                                     dt=0.05, g=9.8):
    """The mean over the param draws of `fused_pendulum_rollout_costs`,
    [n_actions, n_pol], in one launch (counted in
    `fused_pendulum_rollout_costs.launches`). CPU tensors take the plain
    version (`draw_mean_plain`)."""
    if actions.device.type == "cpu":
        return draw_mean_plain(pendulum_rollout_costs_plain(
            state0, actions, lengths, masses, dt=dt, g=g))
    if actions.device.type != "cuda":
        raise ValueError(f"unsupported device {actions.device}")
    mean = torch.empty(actions.shape[:2], dtype=torch.float32,
                       device=actions.device)
    _launch(state0, actions, lengths, masses, dt, g, None, mean)
    return mean


def make_fused_pendulum_state_costs(model):
    """Build the `MultiDisco(fused_state_costs=...)` hook for a
    `PendulumModel`: (state, actions [n_actions, n_pol, H, A], params
    dict|None) -> state costs [n_actions, n_pol], the mean over the
    parameter draws. On the card a call is one launch of K1: the param
    columns are read where they lie and an absent column is the model's
    default, passed as a value."""
    g_def, m_def, l_def = (
        float(model.params_dict["g"]),
        float(model.params_dict["mass"]),
        float(model.params_dict["length"]),
    )

    def hook(state, actions, params):
        s0 = state.reshape(-1)[:2].to(torch.float32)
        lengths, masses = l_def, m_def
        if params is not None:
            unknown = set(params) - {"length", "mass"}
            if unknown:
                raise ValueError(
                    "fused pendulum state-cost hook only supports"
                    f" length/mass parameter columns, got {sorted(unknown)}"
                    " - use the rollout path for other overrides"
                )
            if "length" in params:
                lengths = params["length"].reshape(-1)
            if "mass" in params:
                masses = params["mass"].reshape(-1)
        return fused_pendulum_rollout_cost_mean(
            s0, actions, lengths, masses, dt=float(model.dt), g=g_def)

    return hook
