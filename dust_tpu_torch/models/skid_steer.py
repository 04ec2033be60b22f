"""Kinematic 4-wheel skid-steer robot (Kozlowski & Pazderski 2004),
counterpart of `dust_tpu/models/skid_steer.py`: state
[x, y, theta, v, omega], actions the right and left wheel speeds
(clamped); the uncertain parameters are the ICR x-offset, the wheel
radius and the axial distance. `SkidSteerNavigation` puts it on the
particle task's obstacle course."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device
from ..spaces import Box
from .base import BaseModel, check_device
from .obstacle_map import generate_obstacle_map, get_obst_preset


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
        return self._move(states, actions, params, self.dt)

    def _move(self, states, actions, params, dt):
        """One step of every state over the time `dt` (a number, or a
        tensor that broadcasts against states[..., 0:1])."""
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

        forward_shift = linear_speed * dt
        lateral_shift = -angular_speed * x_icr * dt

        new_x = (x + forward_shift * torch.cos(theta)
                 - lateral_shift * torch.sin(theta))
        new_y = (y + forward_shift * torch.sin(theta)
                 + lateral_shift * torch.cos(theta))
        new_theta = theta + angular_speed * dt
        ones = torch.ones_like(x)
        return torch.cat(
            [new_x, new_y, new_theta, linear_speed * ones,
             angular_speed * ones],
            dim=-1,
        )


class SkidSteerNavigation(SkidSteerRobot):
    """The skid-steer robot on the particle task's obstacle course (the
    port's own task: upstream ships the model with no demo). The course is
    a `Particle` map (`obst_preset`, `obst_width`, `map_size`,
    `map_cell_size`, `map_type`) read at `map_scale` of its size: a world
    point p lies in the map's cell of p / map_scale, so the grid keeps its
    cells and their count. With `can_crash` a robot inside an obstacle
    cell stays in place (its step's time is dt (1 - occupancy)), as the
    particle's does. The cost is the particle's over (x, y, v, omega):
    w_qpos on the position's distance to the target's, w_qvel on the
    speeds', w_ctrl on the wheel speeds, w_obs inside an obstacle; the
    terminal cost w_qpos_T and w_qvel_T. `target` holds the target's
    (x, y, v, omega), `goal_coords(states)` the same coordinates of
    states. `step` is `torch.func.grad`-able in the parameters (the MPF
    differentiates through it)."""

    def __init__(self, delta_t, cost_params, target_state, init_state=None,
                 with_obstacle=False, can_crash=False, obst_preset=None,
                 obst_width=None, map_size=None, map_cell_size=None,
                 map_type=None, map_scale=1.0, device="cuda", **kwargs):
        super().__init__(delta_t, device=device, **kwargs)
        vec = lambda v: torch.tensor(v, dtype=torch.float32,
                                     device=self.device)
        self.target = vec(target_state)
        self.init_state = None if init_state is None else vec(init_state)
        c = cost_params
        self.w_state = vec([c["w_qpos"]] * 2 + [c["w_qvel"]] * 2)
        self.w_term = vec([c["w_qpos_T"]] * 2 + [c["w_qvel_T"]] * 2)
        self.w_ctrl = vec([c["w_ctrl"]] * 2)
        self.w_obs = float(np.float32(c["w_obs"]))
        self.with_obstacle = bool(with_obstacle)
        self.can_crash = bool(can_crash)
        self.obst_map = None
        if self.with_obstacle:
            self.obst_map = generate_obstacle_map(
                map_size, get_obst_preset(obst_preset, obst_width),
                map_cell_size, map_type=map_type)
            # the raster read at map_scale of its size
            self.obst_map.cell_size = float(map_cell_size) * float(map_scale)

    # the load of a configuration without `extra_load`: x_icr unchanged
    no_load = 1.0

    def goal_coords(self, states):
        """(x, y, v, omega) of states [..., 5]."""
        return states[..., [0, 1, 3, 4]]

    def loaded_params(self, true_params, load):
        """The simulator's parameters before the load and after it: the
        dict of the true x_icr, wheel_radius and axial_distance, then the
        same with x_icr times `load` (a load behind the axle)."""
        base = {k: torch.as_tensor(v, dtype=torch.float32,
                                   device=self.device)
                for k, v in true_params.items()}
        return base, {**base, "x_icr": base["x_icr"] * load}

    def _occupancy(self, states):
        return self.obst_map.get_collisions(states[..., 0:2])

    def step(self, states, actions, params=None, generator=None):
        del generator  # deterministic model
        check_device(self, states)
        dt = self.dt
        if self.can_crash and self.with_obstacle:
            dt = dt * (1.0 - self._occupancy(states))[..., None]
        return self._move(states, actions, params, dt)

    def _cost(self, states, weights):
        obst = (self.w_obs * self._occupancy(states) if self.with_obstacle
                else 0.0)
        delta = self.goal_coords(states) - self.target
        return torch.sum(delta * delta * weights, dim=-1) + obst

    def default_inst_cost(self, states, actions=0.0, **_):
        acts = torch.as_tensor(actions, dtype=states.dtype,
                               device=states.device)
        return (self._cost(states, self.w_state)
                + torch.sum(acts * acts * self.w_ctrl, dim=-1))

    def default_term_cost(self, states, **_):
        return self._cost(states, self.w_term)
