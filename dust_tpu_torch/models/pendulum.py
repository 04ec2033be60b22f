"""1-DOF inverted pendulum dynamics (counterpart of
`dust_tpu/models/pendulum.py`): Euler update of [theta, theta_dot] with
torque clamp +-2 and speed clamp +-8."""

from __future__ import annotations

import math

import torch

from ..spaces import Box
from .base import BaseModel


class PendulumModel(BaseModel):
    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0

    def __init__(self, g=9.8, mass=1.0, length=1.0, gym_v0_compat=False,
                 **kwargs):
        params_dict = {"g": g, "mass": mass, "length": length}
        super().__init__(params_dict=params_dict, **kwargs)
        bounds = [float("inf"), self.MAX_SPEED]
        self._observation_space = Box(dim=2, low=[-b for b in bounds], high=bounds)
        self._action_space = Box(dim=1, low=-self.MAX_TORQUE, high=self.MAX_TORQUE)
        # gym Pendulum-v0 advances theta with the UNCLIPPED new theta_dot
        # and clamps the speed afterwards (PARITY #20); the default clamps
        # first
        self.gym_v0_compat = bool(gym_v0_compat)

    @property
    def observation_space(self):
        return self._observation_space

    @property
    def action_space(self):
        return self._action_space

    def step(self, states, actions, params=None, generator=None):
        del generator  # deterministic model
        dt = self.dt
        theta = states[..., 0:1]
        theta_d = states[..., 1:2]
        g, m, length = self.resolve_params(params)

        acts = torch.clamp(actions, -self.MAX_TORQUE, self.MAX_TORQUE)
        theta_d = theta_d + dt * (
            -3.0 * g / (2.0 * length) * torch.sin(theta + math.pi)
            + 3.0 / (m * length**2) * acts
        )
        if self.gym_v0_compat:
            theta = theta + theta_d * dt
            theta_d = torch.clamp(theta_d, -self.MAX_SPEED, self.MAX_SPEED)
        else:
            theta_d = torch.clamp(theta_d, -self.MAX_SPEED, self.MAX_SPEED)
            theta = theta + theta_d * dt  # uses the *new* theta_d
        return torch.cat([theta, theta_d], dim=-1)

    @staticmethod
    def get_obs(state):
        """[theta, theta_dot] -> [cos, sin, theta_dot]."""
        theta = state[..., 0:1]
        theta_d = state[..., 1:2]
        return torch.cat([torch.cos(theta), torch.sin(theta), theta_d], dim=-1)
