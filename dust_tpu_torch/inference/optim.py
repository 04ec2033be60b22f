"""The optimizers of the Stein steps (counterparts of the optax transforms
that `dust_tpu`'s SVMPC, MPF and SVGD take).

Each follows optax's protocol on one tensor: `init(params) -> state` and
`update(grads, state, params=None) -> (updates, state)`, the updates to
add to the parameters. Both also take `update(..., lr=rate)`: the rate of
that one update in place of the optimizer's own, where JAX would carry
the rate in `optax.inject_hyperparams` state (`SVMPCState.lr`).

`make_optimizer(optimizer, lr)` takes the name "sgd" or "adam", or any
object with that protocol, which it returns as it is. Optimizer states
are trees of tensors, numbers, tuples and dataclasses: the sharded
classes split the leaves whose leading axis is the particle axis
(`is_per_particle`) and keep the others, such as Adam's `count`, whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamState:
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


class Adam:
    """`optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8, bias corrected."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = float(lr), b1, b2, eps

    def init(self, params):
        return AdamState(count=0, mu=torch.zeros_like(params),
                         nu=torch.zeros_like(params))

    def update(self, grads, state, params=None, lr=None):
        lr = self.lr if lr is None else float(lr)
        mu = (1 - self.b1) * grads + self.b1 * state.mu
        nu = (1 - self.b2) * (grads * grads) + self.b2 * state.nu
        count = state.count + 1
        # the bias corrections in float32, as optax computes them
        k = torch.tensor(float(count), device=grads.device)
        mu_hat = mu / (1 - torch.tensor(self.b1, device=grads.device) ** k)
        nu_hat = nu / (1 - torch.tensor(self.b2, device=grads.device) ** k)
        updates = -lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        return updates, AdamState(count=count, mu=mu, nu=nu)


class SGD:
    """`optax.sgd(lr)`: the updates are -lr * grads; its state is empty."""

    def __init__(self, lr):
        self.lr = float(lr)

    def init(self, params):
        return ()

    def update(self, grads, state, params=None, lr=None):
        lr = self.lr if lr is None else float(lr)
        return -lr * grads, state


_OPTIMIZERS = {"adam": Adam, "sgd": SGD}


def make_optimizer(optimizer, lr):
    """The optimizer named "sgd" or "adam" at rate `lr`, or `optimizer`
    itself where it has `init` and `update` (its own rate then holds)."""
    if isinstance(optimizer, str):
        if optimizer not in _OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {sorted(_OPTIMIZERS)} or an "
                f"object with init and update, got {optimizer!r}")
        return _OPTIMIZERS[optimizer](lr)
    if not (callable(getattr(optimizer, "init", None))
            and callable(getattr(optimizer, "update", None))):
        raise ValueError(
            f"optimizer must be one of {sorted(_OPTIMIZERS)} or an object "
            f"with init and update, got {optimizer!r}")
    return optimizer


def opt_update(optimizer, grads, state, params, lr=None):
    """`optimizer.update(grads, state, params)`, at the rate `lr` where it
    is not None (a state's own rate; the optimizer must take `lr=`)."""
    if lr is None:
        return optimizer.update(grads, state, params)
    return optimizer.update(grads, state, params, lr=lr)


def is_per_particle(leaf, m):
    """True for the optimizer-state leaves whose leading axis is the
    particle axis of m particles (`dust_tpu/parallel/svmpc_sharded.py:
    _is_per_particle`)."""
    return isinstance(leaf, torch.Tensor) and leaf.shape[:1] == (m,)
