"""`ClosedFormPendulumMPF` of `dust_tpu_torch`: its Stein direction
against the port's autograd `MPF` (`torch.func.grad` through the
pendulum step) and against `dust_tpu`'s `ClosedFormPendulumMPF`, on the
same particles and likelihood state (rtol 1e-5), in linear and log space,
with particles on both sides of the +-8 speed clip that gates the
gradient."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dust_tpu.inference.likelihoods import GaussianLikelihood as JLik
from dust_tpu.inference.mpf import ClosedFormPendulumMPF as JClosed
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu_torch.convert import mpf_state_from_numpy
from dust_tpu_torch.inference import MPF as TMPF
from dust_tpu_torch.inference import ClosedFormPendulumMPF as TClosed
from dust_tpu_torch.inference.likelihoods import GaussianLikelihood as TLik
from dust_tpu_torch.models import PendulumModel as TPendulum

PRIOR_BW = 0.2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(log_space, obs, action, new_obs, m=50, seed=0):
    """JAX's conditioned MPF state and the port's, from the same arrays:
    m (length, mass) particles, an observation, the action taken and the
    next observation."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.6, 1.3, size=(m, 2)).astype(np.float32)
    if log_space:
        x = np.log(x)
    jlik = JLik(obs_std=0.1, log_space=log_space,
                model=JPendulum(uncertain_params=("length", "mass")))
    tlik = TLik(obs_std=0.1, log_space=log_space,
                model=TPendulum(uncertain_params=("length", "mass")))
    jc = JClosed(likelihood=jlik, optimizer=optax.sgd(1e-3))
    ms = jc.init_state(jnp.asarray(x), jnp.asarray(obs), 1, bw=PRIOR_BW)
    ms = ms.replace(lik=jlik.condition(ms.lik, jnp.asarray(action),
                                       jnp.asarray(new_obs)))
    tms = mpf_state_from_numpy(
        ms.x, ms.prior.locs, ms.prior.scale_tril, ms.prior.logits,
        ms.lik.loc, ms.lik.past_obs, ms.lik.past_action, ms.prior_bw,
        device="cpu")
    return jc, ms, tlik, tms


# (obs, action, new_obs): far from the clip; near +8 with a positive
# torque, so that some particles' speed is clipped and some is not
CASES = {
    "free": ([2.7, -0.6], [1.7], [2.65, -0.4]),
    "gate": ([0.5, 6.9], [2.0], [0.9, 8.0]),
    "gate_low": ([-0.4, -7.0], [-2.0], [-0.8, -8.0]),
}


def _crossed(tms, log_space):
    """How many particles' one-step speed leaves the +-8 clip."""
    x = tms.x.exp() if log_space else tms.x
    model = TPendulum(uncertain_params=("length", "mass"))
    past = tms.lik.past_obs
    theta_d = past[1] + model.dt * (
        -1.5 * 9.8 / x[:, 0] * torch.sin(past[0] + np.pi)
        + 3.0 / (x[:, 1] * x[:, 0] ** 2) * tms.lik.past_action.clamp(-2, 2))
    return int((theta_d.abs() >= 8.0).sum())


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("log_space", [False, True])
def test_phi_matches_autograd_mpf_and_jax(log_space, case):
    obs, action, new_obs = CASES[case]
    jc, jms, tlik, tms = _setup(log_space, obs, action, new_obs)
    crossed = _crossed(tms, log_space)
    if case == "free":
        assert crossed == 0
    else:
        assert 0 < crossed < tms.x.shape[0]   # both sides of the gate
    bw = 0.3
    closed = TClosed(likelihood=tlik, lr=1e-3).phi(tms, bw)
    auto = TMPF(likelihood=tlik, lr=1e-3).phi(tms, bw)
    want = np.asarray(jc.phi(jms, bw))
    scale = np.abs(want).max()
    np.testing.assert_allclose(closed.numpy(), auto.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(closed.numpy(), want, rtol=1e-5,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("log_space", [False, True])
def test_optimize_matches_jax(log_space):
    """Six SGD steps (tests/test_pallas_mpf.py's closed-form case) and the
    refreshed prior."""
    jc, jms, tlik, tms = _setup(log_space, *CASES["gate"], seed=1)
    closed = TClosed(likelihood=tlik, lr=1e-3, reference_compat=True)
    assert not closed.reference_compat
    jout, _, _ = jc.optimize(jms, jms.lik.past_action, None, bw=0.3,
                             n_steps=6)
    tout, norms, _ = closed.optimize(tms, tms.lik.past_action, None, bw=0.3,
                                     n_steps=6)
    np.testing.assert_allclose(tout.x.numpy(), np.asarray(jout.x),
                               rtol=1e-5, atol=1e-6)
    assert norms.shape == (6,) and np.isfinite(norms.numpy()).all()
    np.testing.assert_allclose(tout.prior.locs.numpy(),
                               np.asarray(jout.prior.locs), rtol=1e-5,
                               atol=1e-6)
