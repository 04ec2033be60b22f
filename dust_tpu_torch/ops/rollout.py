"""Fused pendulum rollout costs (K1): counterpart of
`dust_tpu/ops/pallas_rollout.py`.

The SVMPC Stein step consumes only per-sequence costs, never the
trajectories. `fused_pendulum_rollout_costs` evolves all n_params x
n_actions x n_pol pendulum trajectories and returns only their swing-up
costs sum_{t<H} inst(s_t) + term(s_H), as [n_params, n_actions, n_pol].

* On CUDA tensors it launches the hand-written kernel
  `csrc/pendulum_rollout.cu` (which replaces the TPU kernel
  `dust_tpu/ops/pallas_rollout.py:fused_pendulum_rollout_costs`). The
  kernel is bound by launch latency and its 30-step dependent chain, not
  by bytes or arithmetic; it keeps one trajectory per thread with its
  state in registers.
* On CPU tensors it runs `pendulum_rollout_costs_plain`, the same
  arithmetic in plain PyTorch, operation by operation.

Physics matches `PendulumModel.step` (torque clamp +-2, Euler update,
speed clamp +-8, new-theta_d integration) and the cost matches
`experiments.pendulum_cost_fns` (50 (cos th - 1)^2 + th_dot^2).
"""

from __future__ import annotations

import math

import torch

from ..models.pendulum import PendulumModel

_MAX_SPEED = PendulumModel.MAX_SPEED
_MAX_TORQUE = PendulumModel.MAX_TORQUE
# the swing-up cost weight of `experiments.pendulum_cost_fns`
_SWINGUP_W = 50.0


def _swingup(th, om):
    return _SWINGUP_W * (torch.cos(th) - 1.0) ** 2 + om * om


def pendulum_rollout_costs_plain(state0, actions, lengths, masses, dt=0.05,
                                 g=9.8):
    """Plain PyTorch version of the kernel: state0 [2], actions
    [n_actions, n_pol, H, 1], lengths/masses [n_params] ->
    [n_params, n_actions, n_pol]."""
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


def fused_pendulum_rollout_costs(state0, actions, lengths, masses, dt=0.05,
                                 g=9.8):
    """State costs of every (param draw, action sample, policy) pendulum
    rollout. state0 [2]; actions [n_actions, n_pol, H, 1] (shared across
    param draws); lengths/masses [n_params]. Returns
    [n_params, n_actions, n_pol].

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in `fused_pendulum_rollout_costs.launches`)."""
    if actions.device.type == "cpu":
        return pendulum_rollout_costs_plain(state0, actions, lengths, masses,
                                            dt=dt, g=g)
    if actions.device.type != "cuda":
        raise ValueError(f"unsupported device {actions.device}")
    n_act, n_pol, hz, a_dim = actions.shape
    n_params = lengths.shape[0]
    tensors = (state0, actions, lengths, masses)
    if a_dim != 1 or state0.numel() != 2 or masses.shape != (n_params,):
        raise ValueError(
            "expected state0 [2], actions [n_act, n_pol, H, 1], "
            "lengths/masses [n_params]"
        )
    if any(t.dtype != torch.float32 or t.device != actions.device
           for t in tensors):
        raise ValueError("all inputs must be float32 on the same device")
    if n_params * n_act * n_pol == 0 or hz == 0:
        raise ValueError("empty rollout batch")
    from ._build import check, load_library

    state0, actions, lengths, masses = (t.contiguous() for t in tensors)
    costs = torch.empty((n_params, n_act, n_pol), dtype=torch.float32,
                        device=actions.device)
    rc = load_library().dust_pendulum_rollout_costs(
        state0.data_ptr(), actions.data_ptr(), lengths.data_ptr(),
        masses.data_ptr(), costs.data_ptr(), n_params, n_act * n_pol, hz,
        -3.0 * g * 0.5 * dt, 3.0 * dt, dt,
        torch.cuda.current_stream(actions.device).cuda_stream,
    )
    fused_pendulum_rollout_costs.launches += 1
    check(rc, "pendulum_rollout_costs")
    return costs


fused_pendulum_rollout_costs.launches = 0


def make_fused_pendulum_state_costs(model):
    """Build the `MultiDisco(fused_state_costs=...)` hook for a
    `PendulumModel`: (state, actions [n_actions, n_pol, H, A], params
    dict|None) -> state costs [n_actions, n_pol], the mean over the
    parameter draws."""
    g_def, m_def, l_def = (
        float(model.params_dict["g"]),
        float(model.params_dict["mass"]),
        float(model.params_dict["length"]),
    )

    def hook(state, actions, params):
        s0 = state.reshape(-1)[:2].to(torch.float32)
        default_l = torch.full((1,), l_def, device=actions.device)
        default_m = torch.full((1,), m_def, device=actions.device)
        if params is None:
            lengths, masses = default_l, default_m
        else:
            unknown = set(params) - {"length", "mass"}
            if unknown:
                raise ValueError(
                    "fused pendulum state-cost hook only supports"
                    f" length/mass parameter columns, got {sorted(unknown)}"
                    " - use the rollout path for other overrides"
                )
            lengths = params["length"].reshape(-1) if "length" in params \
                else default_l
            masses = params["mass"].reshape(-1) if "mass" in params \
                else default_m
            if lengths.shape[0] != masses.shape[0]:
                n = max(lengths.shape[0], masses.shape[0])
                lengths = lengths.expand(n)
                masses = masses.expand(n)
        costs = fused_pendulum_rollout_costs(
            s0, actions, lengths, masses, dt=float(model.dt), g=g_def,
        )
        return costs.mean(dim=0)

    return hook
