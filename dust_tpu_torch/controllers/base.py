"""Controller support: derivative helpers (counterpart of
`dust_tpu/controllers/base.py`), written with `torch.func`.

`get_jacobian` and `get_hessian` keep the reference's flattened
contract, (out_size, in_size) and (in_size, in_size);
`linearize_model` gives a model's discrete-time (A, B).
"""

from __future__ import annotations

import torch


def get_jacobian(func, inputs):
    """Jacobian of `func` at `inputs` over the flattened input and output:
    [out_size, in_size]."""
    inputs = torch.as_tensor(inputs)

    def flat_func(x_flat):
        return func(x_flat.reshape(inputs.shape)).reshape(-1)

    return torch.func.jacrev(flat_func)(inputs.reshape(-1))


def get_hessian(func, inputs):
    """Hessian of the sum of `func` at `inputs` over the flattened input:
    [in_size, in_size]."""
    inputs = torch.as_tensor(inputs)

    def flat_func(x_flat):
        return func(x_flat.reshape(inputs.shape)).sum()

    return torch.func.hessian(flat_func)(inputs.reshape(-1))


def linearize_model(model, state, action, params=None):
    """(A, B) = d step / d (state, action) at one state and action."""
    f_s = torch.func.jacrev(lambda s: model.step(s, action, params))(state)
    f_a = torch.func.jacrev(lambda a: model.step(state, a, params))(action)
    return f_s, f_a
