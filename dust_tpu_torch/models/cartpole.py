"""Cart-pole with friction (Barto, Sutton & Anderson 1983), counterpart of
`dust_tpu/models/cartpole.py`.

It keeps the JAX package's two fixes to the reference: the total mass is
`mass_cart + mass_pole` (the reference adds the cart's mass twice), and
the sampled-params path works (the reference reads a name-mangled
attribute that does not exist).
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from ..spaces import Box
from .base import BaseModel, check_device


class CartPoleModel(BaseModel):
    """State [x, x_dot, theta, theta_dot], action a force in [-1, 1]
    scaled by `f_mag`. `step` takes tensors on `device`."""

    def __init__(
        self,
        g=9.8,
        f_mag=10.0,
        mass_cart=1.0,
        mass_pole=0.1,
        length=1.0,
        mu_c=0.5e-3,
        mu_p=2e-6,
        device="cuda",
        **kwargs,
    ):
        params_dict = {
            "g": g,
            "mass_cart": mass_cart,
            "mass_pole": mass_pole,
            "length": length,
            "mu_c": mu_c,
            "mu_p": mu_p,
            "f_mag": f_mag,
        }
        super().__init__(params_dict=params_dict, **kwargs)
        self.device = resolve_device(device)
        self.theta_threshold_radians = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4
        high = [
            self.x_threshold * 2,
            float("inf"),
            self.theta_threshold_radians * 2,
            float("inf"),
        ]
        self._action_space = Box(dim=1, low=-1, high=1)
        self._observation_space = Box(dim=4, low=[-h for h in high], high=high)

    @property
    def observation_space(self):
        return self._observation_space

    @property
    def action_space(self):
        return self._action_space

    def step(self, states, actions, params=None, generator=None):
        del generator  # deterministic model
        check_device(self, states)
        dt = self.dt
        x_d = states[..., 1:2]
        theta = states[..., 2:3]
        theta_d = states[..., 3:4]
        g, m_c, m_p, length, mu_c, mu_p, f_mag = self.resolve_params(params)

        acts = torch.clamp(actions, -1.0, 1.0) * f_mag
        mass = m_c + m_p  # total mass (the reference: m_c + m_c)
        pm = m_p * length
        cart_friction = mu_c * torch.sign(x_d)
        pole_friction = (mu_p * theta_d) / pm
        factor = (acts + pm * torch.sin(theta) * theta_d**2
                  - cart_friction) / mass
        tdd_num = g * torch.sin(theta) - torch.cos(theta) * factor \
            - pole_friction
        tdd_den = length * (4.0 / 3 - (m_p * torch.cos(theta) ** 2) / mass)
        theta_dd = tdd_num / tdd_den
        x_dd = factor - pm * theta_dd * torch.cos(theta) / mass
        delta = torch.cat([x_d, x_dd, theta_d, theta_dd], dim=-1) * dt
        return states + delta
