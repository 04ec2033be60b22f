"""Kinematic 4-wheel skid-steer robot (Kozlowski & Pazderski 2004),
counterpart of `dust_tpu/models/skid_steer.py`: state
[x, y, theta, v, omega], actions the right and left wheel speeds
(clamped); the uncertain parameters are the ICR x-offset, the wheel
radius and the axial distance."""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from ..spaces import Box
from .base import BaseModel, check_device


class SkidSteerRobot(BaseModel):
    """`step` takes tensors on `device`."""

    def __init__(
        self,
        delta_t,
        x_icr=0.2,
        wheel_radius=0.0625,
        axial_distance=0.475,
        min_wheel_speed=-0.5,
        max_wheel_speed=0.5,
        device="cuda",
        **kwargs,
    ):
        params_dict = {
            "x_icr": x_icr,
            "wheel_radius": wheel_radius,
            "axial_distance": axial_distance,
        }
        super().__init__(dt=delta_t, params_dict=params_dict, **kwargs)
        self.device = resolve_device(device)
        self._observation_space = Box(dim=5)
        self._action_space = Box(dim=2, low=min_wheel_speed,
                                 high=max_wheel_speed)

    @property
    def observation_space(self):
        return self._observation_space

    @property
    def action_space(self):
        return self._action_space

    def step(self, states, actions, params=None, generator=None):
        del generator  # deterministic model
        check_device(self, states)
        x = states[..., 0:1]
        y = states[..., 1:2]
        theta = states[..., 2:3]
        x_icr, wheel_radius, axial_distance = self.resolve_params(params)
        low, high = self._action_space.low, self._action_space.high

        right = torch.clamp(actions[..., 0:1], float(low[0]), float(high[0]))
        left = torch.clamp(actions[..., 1:2], float(low[1]), float(high[1]))

        linear_speed = (right + left) * math.pi * wheel_radius
        angular_speed = ((right - left) * 2 * math.pi * wheel_radius
                         / axial_distance)

        forward_shift = linear_speed * self.dt
        lateral_shift = -angular_speed * x_icr * self.dt

        new_x = (x + forward_shift * torch.cos(theta)
                 - lateral_shift * torch.sin(theta))
        new_y = (y + forward_shift * torch.sin(theta)
                 + lateral_shift * torch.cos(theta))
        new_theta = theta + angular_speed * self.dt
        ones = torch.ones_like(x)
        return torch.cat(
            [new_x, new_y, new_theta, linear_speed * ones,
             angular_speed * ones],
            dim=-1,
        )
