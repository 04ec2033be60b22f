"""Base dynamics-model protocol (counterpart of `dust_tpu/models/base.py`).

A model is a stateless object exposing one batched transition function:

    step(states [..., S], actions [..., A], params=None, generator=None)
        -> [..., S]

`params` is a dict of tensors keyed by `uncertain_params` that broadcast
against the batch axes; `generator` carries randomness for stochastic
models.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch


class BaseModel(ABC):
    def __init__(self, dt=0.05, params_dict=None, uncertain_params=None):
        if dt <= 0:
            raise ValueError("Delta t must be greater than zero.")
        self._dt = float(dt)
        self._params_dict = dict(params_dict or {})
        self._params_keys = tuple(uncertain_params) if uncertain_params else None

    @property
    def dt(self):
        return self._dt

    @property
    def params_dict(self):
        """Default (nominal) parameter values."""
        return self._params_dict

    @params_dict.setter
    def params_dict(self, params_dict):
        self._params_dict = dict(params_dict)

    @property
    def uncertain_params(self):
        return self._params_keys

    @property
    @abstractmethod
    def observation_space(self):
        ...

    @property
    @abstractmethod
    def action_space(self):
        ...

    @abstractmethod
    def step(self, states, actions, params=None, generator=None):
        """Batched transition function; see module docstring."""
        ...

    def resolve_params(self, params):
        """Merge a sampled-params dict over the defaults, returning the
        model's full ordered parameter tuple."""
        merged = dict(self._params_dict)
        if params is not None:
            merged.update(params)
        return tuple(merged.values())

    def params_to_dict(self, params):
        """[n, P] tensor of sampled uncertain params -> dict of [n, 1]
        columns keyed by `uncertain_params`."""
        if params.ndim == 1:
            params = params[:, None]
        return {
            key: params[:, idx].reshape(-1, 1)
            for idx, key in enumerate(self._params_keys)
        }

    def dict_to_params(self, params_dict):
        return torch.cat(
            [params_dict[key].reshape(-1, 1) for key in self._params_keys],
            dim=1,
        )

    def set_params_from_dist(self, params_dist):
        mean = np.atleast_1d(params_dist.mean.detach().cpu().numpy())
        for idx, key in enumerate(self._params_keys):
            self._params_dict[key] = float(mean[idx])

    def sample_params(self, generator, params_dist, num_samples,
                      x_min=-np.inf, x_max=np.inf, max_rounds=16):
        """Bounded parameter samples as a dict: a fixed number of masked
        resampling rounds in place of a data-dependent rejection loop."""
        dim = len(self._params_keys)
        samples = params_dist.sample(generator, (num_samples,)).reshape(
            num_samples, dim
        )
        for _ in range(max_rounds - 1):
            fresh = params_dist.sample(generator, (num_samples,)).reshape(
                num_samples, dim
            )
            bad = ((samples <= x_min) | (samples >= x_max)).any(dim=1)
            samples = torch.where(bad[:, None], fresh, samples)
        return {
            key: samples[:, idx].reshape(-1, 1)
            for idx, key in enumerate(self._params_keys)
        }


def check_device(model, states):
    """Raise unless `states` lie on the device `model` was built for."""
    if states.device.type != model.device.type:
        raise ValueError(
            f"{type(model).__name__} was built for {model.device}, got "
            f"states on {states.device}"
        )
