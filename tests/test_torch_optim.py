"""`dust_tpu_torch.inference.optim`: SGD and Adam against `optax.sgd` and
`optax.adam` over 20 updates (from a fresh state and from a state whose
count is past 1000, started from the same moments through
`convert.adam_state_from_numpy`), a state's own rate, `make_optimizer`'s
names and objects, and the classes that step inside a kernel (K2, K3,
K7, K8, K13) refusing any optimizer but SGD.

Tolerance: rtol 1e-5, atol 1e-7 on the updates and the moments (the same
float32 arithmetic; the bias correction's power may differ by an ulp
between the two libraries); the count exactly."""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dust_tpu_torch.convert import (
    adam_state_from_numpy,
    mpf_state_from_numpy,
    svmpc_state_from_numpy,
)
from dust_tpu_torch.experiments import (
    PARTICLE_DEMO_CONFIG,
    PENDULUM_DEMO_CONFIG,
    build_particle_stack,
    build_pendulum_stack,
)
from dust_tpu_torch.inference import (
    MPF,
    FusedMPF,
    FusedParticleMPF,
    FusedParticleSVMPC,
    FusedPendulumMPF,
    FusedPendulumSVMPC,
    GaussianLikelihood,
)
from dust_tpu_torch.inference.optim import (
    SGD,
    Adam,
    AdamState,
    make_optimizer,
    opt_update,
)
from dust_tpu_torch.models import PendulumModel

TOL = dict(rtol=1e-5, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(rng, shape):
    """Gradients bounded away from zero (|g| >= 0.05): Adam's first step
    is lr * g / (|g| + eps), so a gradient near zero would turn an ulp
    into a step of up to 2 lr."""
    g = rng.uniform(0.05, 3.0, size=shape) * rng.choice([-1.0, 1.0],
                                                        size=shape)
    return g.astype(np.float32)


@pytest.mark.parametrize("start_count", [0, 1200])
@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_optimizers_match_optax(name, start_count):
    rng = np.random.default_rng(start_count + len(name))
    shape = (6, 4, 1)
    params = rng.normal(size=shape).astype(np.float32)
    jopt = optax.sgd(0.05) if name == "sgd" else optax.adam(0.05)
    topt = make_optimizer(name, 0.05)
    assert isinstance(topt, SGD if name == "sgd" else Adam)
    jstate = jopt.init(jnp.asarray(params))
    tstate = topt.init(torch.tensor(params))
    if name == "adam" and start_count:
        mu = rng.normal(size=shape).astype(np.float32)
        nu = rng.uniform(0.1, 2.0, size=shape).astype(np.float32)
        jstate = (optax.ScaleByAdamState(count=jnp.int32(start_count),
                                         mu=jnp.asarray(mu),
                                         nu=jnp.asarray(nu)),) + jstate[1:]
        tstate = adam_state_from_numpy(np.asarray(jstate[0].count), mu, nu,
                                       device="cpu")
    jp, tp = jnp.asarray(params), torch.tensor(params)
    for _ in range(20):
        g = _grads(rng, shape)
        jupd, jstate = jopt.update(jnp.asarray(g), jstate, jp)
        tupd, tstate = topt.update(torch.tensor(g), tstate, tp)
        np.testing.assert_allclose(tupd.numpy(), np.asarray(jupd), **TOL)
        jp = optax.apply_updates(jp, jupd)
        tp = tp + tupd
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    if name == "adam":
        assert tstate.count == int(jstate[0].count) == start_count + 20
        np.testing.assert_allclose(tstate.mu.numpy(),
                                   np.asarray(jstate[0].mu), **TOL)
        np.testing.assert_allclose(tstate.nu.numpy(),
                                   np.asarray(jstate[0].nu), **TOL)
    else:
        assert tstate == ()


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_a_states_rate_replaces_the_optimizers(name):
    """`opt_update(..., lr=r)` is the update of the same optimizer built
    at rate r (`SVMPCState.lr`, JAX's injected hyperparameter)."""
    rng = np.random.default_rng(3)
    g = torch.tensor(_grads(rng, (5, 2)))
    p = torch.zeros(5, 2)
    own = make_optimizer(name, 0.5)
    at = make_optimizer(name, 0.02)
    got, got_state = opt_update(own, g, own.init(p), p, lr=0.02)
    want, want_state = opt_update(at, g, at.init(p), p)
    assert torch.equal(got, want)
    if name == "adam":
        assert isinstance(got_state, AdamState)
        assert torch.equal(got_state.nu, want_state.nu)
    # None keeps the optimizer's own rate
    assert torch.equal(opt_update(own, g, own.init(p), p)[0],
                       own.update(g, own.init(p), p)[0])


def test_states_from_numpy_carry_the_optimizer_state():
    """`svmpc_state_from_numpy` and `mpf_state_from_numpy` take an
    optimizer state (SGD's () by default); `adam_state_from_numpy` turns
    optax's arrays into the port's `AdamState`."""
    rng = np.random.default_rng(4)
    theta = rng.normal(size=(3, 5, 1)).astype(np.float32)
    jstate = optax.adam(0.1).init(jnp.asarray(theta))[0]
    adam = adam_state_from_numpy(jstate.count, jstate.mu, jstate.nu,
                                 device="cpu")
    assert adam.count == 0 and adam.mu.shape == theta.shape
    sv = svmpc_state_from_numpy(theta, theta, np.eye(1), np.zeros(3),
                                device="cpu", opt_state=adam)
    assert sv.opt_state is adam
    assert svmpc_state_from_numpy(theta, theta, np.eye(1), np.zeros(3),
                                  device="cpu").opt_state == ()
    x = rng.normal(size=(6, 2)).astype(np.float32)
    ms = mpf_state_from_numpy(x, x, np.eye(2), np.zeros(6), [0.0, 0.0],
                              [0.0, 0.0], [0.0], 0.2, device="cpu",
                              opt_state=Adam(0.1).init(torch.tensor(x)))
    assert ms.opt_state.count == 0 and ms.opt_state.nu.shape == (6, 2)


def test_make_optimizer_names_and_objects():
    class Halve:
        def init(self, params):
            return ()

        def update(self, grads, state, params=None):
            return -0.5 * grads, state

    obj = Halve()
    assert make_optimizer(obj, 0.1) is obj
    assert make_optimizer("adam", 0.3).lr == 0.3
    for bad in ("rmsprop", "Adam", object()):
        with pytest.raises(ValueError, match="optimizer must be one of"):
            make_optimizer(bad, 0.1)


def _pendulum_lik():
    return GaussianLikelihood(
        obs_std=0.1, model=PendulumModel(uncertain_params=("length",
                                                           "mass")))


def test_kernel_steppers_refuse_other_optimizers():
    """K2 (FusedPendulumMPF, also through from_mpf), K7
    (FusedParticleMPF), K13 (FusedMPF(fuse_streams=True)), K3
    (FusedPendulumSVMPC) and K8 (FusedParticleSVMPC) step by SGD inside
    their kernels: "adam" raises; "sgd" builds."""
    lik = _pendulum_lik()
    with pytest.raises(ValueError, match="SGD"):
        FusedPendulumMPF(lik, optimizer="adam")
    with pytest.raises(ValueError, match="SGD"):
        FusedPendulumMPF.from_mpf(MPF(lik, optimizer="adam"))
    assert isinstance(FusedPendulumMPF.from_mpf(MPF(lik)).optimizer, SGD)
    with pytest.raises(ValueError, match="SGD"):
        FusedMPF(lik, fuse_streams=True, fused_lr=1e-3, optimizer="adam")
    assert isinstance(FusedMPF(lik, optimizer="adam").optimizer, Adam)

    pstack = build_particle_stack(copy.deepcopy(PARTICLE_DEMO_CONFIG),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    plik = pstack.mpf.likelihood
    with pytest.raises(ValueError, match="SGD"):
        FusedParticleMPF(plik, optimizer="adam")
    with pytest.raises(ValueError, match="SGD"):
        FusedParticleMPF.from_mpf(MPF(plik, optimizer="adam"))

    for cfg, build, cls in (
            (PENDULUM_DEMO_CONFIG, build_pendulum_stack, FusedPendulumSVMPC),
            (PARTICLE_DEMO_CONFIG, build_particle_stack,
             FusedParticleSVMPC)):
        stack = build(copy.deepcopy(cfg), torch.Generator().manual_seed(0),
                      device="cpu")
        sv = stack.svmpc
        kw = dict(n_particles=sv.n_particles, ctrl_dim=sv.ctrl_dim,
                  weighted_prior=sv.weighted_prior)
        assert isinstance(cls(sv.likelihood, optimizer="sgd", **kw)
                          .optimizer, SGD)
        with pytest.raises(ValueError, match="SGD"):
            cls(sv.likelihood, optimizer="adam", **kw)
