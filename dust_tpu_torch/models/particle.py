"""2-D point-mass navigation model with occupancy-grid obstacles
(counterpart of `dust_tpu/models/particle.py`).

Single or double integrator (velocity or acceleration control), optional
Gaussian control noise drawn from an explicit `torch.Generator`, crash
semantics in which a particle inside an obstacle cell freezes in place,
and the built-in quadratic + obstacle cost functions. `step` is
`torch.func.grad`-able in the mass (the MPF differentiates through it;
`floor` in the collision test has a zero gradient, as in JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..spaces import Box
from .base import BaseModel
from .obstacle_map import generate_obstacle_map, get_obst_preset


class Particle(BaseModel):
    def __init__(
        self,
        mass=1.0,
        noise_std=(0.0, 0.0),
        control_type="acceleration",
        cost_params=None,
        with_obstacle=False,
        obst_preset=None,
        obst_width=None,
        obst_params=None,
        map_size=None,
        map_type=None,
        map_cell_size=None,
        init_state=None,
        target_state=None,
        can_crash=False,
        max_speed=None,
        max_accel=None,
        verbose=False,
        deterministic=False,
        euler_steps=1,
        device="cuda",
        **kwargs,
    ):
        params_dict = {"mass": float(np.asarray(mass))}
        super().__init__(params_dict=params_dict, **kwargs)
        self.device = resolve_device(device)
        self.max_speed = float("inf") if max_speed is None else float(max_speed)
        self.max_acc = float("inf") if max_accel is None else float(max_accel)
        self.control_type = control_type
        if control_type == "velocity":
            self._observation_space = Box(dim=2)
            self._action_space = Box(dim=2, low=-self.max_speed,
                                     high=self.max_speed)
        elif control_type == "acceleration":
            bounds = [np.inf, np.inf, self.max_speed, self.max_speed]
            self._observation_space = Box(
                dim=4, low=[-b for b in bounds], high=bounds
            )
            self._action_space = Box(dim=2, low=-self.max_acc,
                                     high=self.max_acc)
        else:
            raise IOError(f'control_type "{control_type}" not recognized')

        dim_s = self._observation_space.dim
        self.target = (
            torch.zeros(dim_s, device=self.device)
            if target_state is None
            else self._vec(target_state)
        )
        self.dyn_std = self._vec(noise_std)
        self.init_state = (
            None if init_state is None else self._vec(init_state)
        )
        self.euler_steps = euler_steps
        self.deterministic = bool(deterministic)
        self.with_obstacle = bool(with_obstacle)
        self.can_crash = bool(can_crash)
        self.verbose = verbose

        self.obst_map = None
        if self.with_obstacle:
            self.obst_params = get_obst_preset(obst_preset, obst_width)
            self.obst_map = generate_obstacle_map(
                map_size, self.obst_params, map_cell_size, map_type=map_type
            )
        self.map_cell_size = map_cell_size
        self.map_size = map_size

        self.init_cost_weights(cost_params)

    def _vec(self, values):
        return torch.tensor(np.asarray(values, dtype=np.float32),
                            device=self.device)

    @property
    def observation_space(self):
        return self._observation_space

    @property
    def action_space(self):
        return self._action_space

    def step(self, states, actions, params=None, generator=None):
        """One Euler step of every state; `generator` supplies the control
        noise when the model is stochastic."""
        (m,) = self.resolve_params(params)
        acts = actions
        if not self.deterministic and generator is not None:
            acts = acts + self.dyn_std * torch.randn(
                acts.shape, generator=generator, dtype=acts.dtype,
                device=acts.device)
        if self.control_type == "acceleration":
            acts = torch.clamp(acts / m, -self.max_acc, self.max_acc)
        else:
            acts = torch.clamp(acts, -self.max_speed, self.max_speed)
        lead = torch.broadcast_shapes(states.shape[:-1], acts.shape[:-1])
        x_dot = torch.cat([states[..., 2:].expand(*lead, -1),
                           acts.expand(*lead, -1)], dim=-1)
        if self.can_crash and self.with_obstacle:
            # collided particles have crashed and freeze in place
            collision = self.obst_map.get_collisions(states[..., 0:2])[..., None]
            next_states = states + x_dot * self.dt * (1.0 - collision)
        else:
            next_states = states + x_dot * self.dt
        vel = torch.clamp(next_states[..., -2:], -self.max_speed,
                          self.max_speed)
        return torch.cat([next_states[..., :-2], vel], dim=-1)

    # -- the navigation episode (simulation.particle_episode_fn) -------------

    # the load of a configuration without `extra_load`
    no_load = 0.0

    def goal_coords(self, states):
        """The coordinates the goal test measures: the whole state."""
        return states

    def loaded_params(self, true_params, load):
        """The simulator's parameters before the load and after it: the
        true mass, then the mass plus `load`."""
        mass = torch.as_tensor(true_params, dtype=torch.float32,
                               device=self.device)
        return {"mass": mass}, {"mass": mass + load}

    # -- built-in cost functions -------------------------------------------

    def default_inst_cost(self, states, actions=0.0, **_):
        if self.with_obstacle:
            obst_cost = self.w_obs * self.obst_map.get_collisions(
                states[..., 0:2])
        else:
            obst_cost = 0.0
        delta = states - self.target
        state_cost = torch.sum(delta * delta * self.w_state, dim=-1)
        acts = torch.as_tensor(actions, dtype=states.dtype,
                               device=states.device)
        control_cost = torch.sum(acts * acts * self.w_ctrl, dim=-1)
        return state_cost + control_cost + obst_cost

    def default_term_cost(self, states, **_):
        if self.with_obstacle:
            obst_cost = self.w_obs * self.obst_map.get_collisions(
                states[..., 0:2])
        else:
            obst_cost = 0.0
        delta = states - self.target
        return torch.sum(delta * delta * self.w_term, dim=-1) + obst_cost

    def init_cost_weights(self, params):
        """The cost-weight vectors from `cost_params` (all 1.0 when None)."""
        if params is None:
            params = dict.fromkeys(
                ["w_qpos", "w_qvel", "w_qpos_T", "w_qvel_T", "w_ctrl", "w_obs"],
                1.0)
        w_qpos = [params["w_qpos"]] * 2
        w_qvel = [params["w_qvel"]] * 2
        if self.control_type == "velocity":
            self.w_state = self._vec(w_qpos)
        else:
            self.w_state = self._vec(w_qpos + w_qvel)
        self.w_ctrl = self._vec([params["w_ctrl"]] * self._action_space.dim)
        w_qpos_t = [params["w_qpos_T"]] * 2
        w_qvel_t = [params["w_qvel_T"]] * 2
        if self.control_type == "velocity":
            self.w_term = self._vec(w_qpos_t)
        else:
            self.w_term = self._vec(w_qpos_t + w_qvel_t)
        self.w_obs = float(np.float32(params["w_obs"]))

    def to_map_coord(self, coord_vec):
        """World -> map-cell coordinates."""
        coord = torch.as_tensor(coord_vec, dtype=torch.float32,
                                device=self.device)
        return (torch.as_tensor(self.obst_map.c_offset, device=self.device)
                + coord / self.map_cell_size)
