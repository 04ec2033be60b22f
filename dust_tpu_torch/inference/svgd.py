"""Generic Stein variational gradient descent (counterpart of
`dust_tpu/inference/svgd.py`).

A functional SVGD over a user `log_p_fn`: the particles are the tensor
you pass in, the score is `torch.func.grad` of sum(log_p_fn), and the
repulsion is the standard -G (G_i = grad_{x_i} sum_j k(x_i, x_j), the
gradient through the first kernel argument), divided by n with the
driving term. The optimizer is what `optim.make_optimizer` takes: "adam"
(the default, the arithmetic of `optax.adam(lr)`: b1 0.9, b2 0.999, eps
1e-8, bias corrected), "sgd" (`x + lr * phi`) or an optimizer object.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..ops.bandwidth import bw_median
from ..ops.kernels import rbf_gram, rbf_gram_and_grad
from .optim import SGD, Adam, AdamState, make_optimizer  # noqa: F401


class SVGD:
    """Functional SVGD: every method is a function of the particles you
    pass in. `device` is where `optimize` puts given initial
    particles."""

    def __init__(self, bw_scale=1.0, n_particles=None, n_steps=100,
                 optimizer="adam", lr=1e-2, device="cuda"):
        self.device = resolve_device(device)
        self.bw_scale = float(bw_scale)
        self.n_particles = n_particles
        self.n_steps = int(n_steps)
        self.optimizer = make_optimizer(optimizer, lr)

    def score_matrix(self, x, log_p_fn):
        return torch.func.grad(lambda xs: log_p_fn(xs).sum())(x)

    def phi(self, x, log_p_fn, bw):
        """Stein direction ((K @ score) - G) / n."""
        score = self.score_matrix(x, log_p_fn)
        flat = x.reshape(x.shape[0], -1)
        k, grad_first = rbf_gram_and_grad(flat, flat, bw)
        grad_k = -grad_first.reshape(x.shape)
        return (torch.tensordot(k, score, dims=1) + grad_k) / x.shape[0]

    def step(self, x, opt_state, log_p_fn, bw):
        updates, opt_state = self.optimizer.update(
            -self.phi(x, log_p_fn, bw), opt_state)
        return x + updates, opt_state

    def optimize(self, log_p_fn, initial_particles=None, prior=None,
                 generator=None, bw=None, n_steps=None):
        """`n_steps` optimizer steps from the initial particles (or
        `n_particles` draws of `prior` from `generator`). With `bw=None`
        the bandwidth comes from the median trick once, up front; an
        explicit `bw` is used as given. Returns the final particles."""
        if initial_particles is not None:
            x = torch.as_tensor(initial_particles, dtype=torch.float32,
                                device=self.device)
        elif prior is not None:
            if generator is None:
                raise ValueError("prior sampling requires a generator")
            x = prior.sample(generator, (self.n_particles,))
        else:
            raise RuntimeError(
                "Either initial_particles or prior must be specified for SVGD"
            )
        if bw is None:
            flat = x.reshape(x.shape[0], -1)
            bw = bw_median(flat, flat, self.bw_scale)
        opt_state = self.optimizer.init(x)
        for _ in range(self.n_steps if n_steps is None else n_steps):
            x, opt_state = self.step(x, opt_state, log_p_fn, bw)
        return x

    def discrepancy(self, x, log_p_fn):
        """Kernelized Stein discrepancy estimate."""
        s = self.score_matrix(x, log_p_fn)
        flat = x.reshape(x.shape[0], -1)
        s = s.reshape(s.shape[0], -1)
        bw = bw_median(flat, flat)
        k = rbf_gram(flat, flat, bw)
        d = flat.shape[1]
        return torch.sqrt(torch.mean(k * (s @ s.T + d / bw**2)))
