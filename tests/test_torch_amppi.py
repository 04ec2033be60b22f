"""`dust_tpu_torch.controllers.AMPPI` against `dust_tpu.controllers.AMPPI`.

All randomness is injected: the action noise through `eps_noise` (or
the actions through `ext_actions`), the parameter draws of the 'single'
and 'extended' modes through stub distributions; the sigma points are
deterministic. Tolerances are tests/test_amppi.py's: costs rtol 2e-4,
states and a_seq atol 1e-4, omega atol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.controllers import AMPPI as JAMPPI
from dust_tpu.distributions import Uniform as JUniform
from dust_tpu.experiments import pendulum_cost_fns as j_cost_fns
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.utils.utf import MerweScaledUTF as JUTF
from dust_tpu_torch.controllers import AMPPI as TAMPPI
from dust_tpu_torch.convert import amppi_state_from_numpy
from dust_tpu_torch.distributions import Uniform as TUniform
from dust_tpu_torch.experiments import pendulum_cost_fns as t_cost_fns
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.utils import MerweScaledUTF as TUTF

HORIZON = 10
N_SAMPLES = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


class _JStub:
    def __init__(self, draws):
        self.draws = jnp.asarray(draws)

    def sample(self, key, shape):
        assert self.draws.shape[0] == shape[0]
        return self.draws


class _TStub:
    def __init__(self, draws):
        self.draws = _t(draws)

    def sample(self, generator, shape):
        assert self.draws.shape[0] == shape[0]
        return self.draws


def _pair(mode):
    kw = dict(hz_len=HORIZON, n_samples=N_SAMPLES, lambda_=0.8)
    jm = JPendulum(uncertain_params=("length", "mass"))
    tm = TPendulum(uncertain_params=("length", "mass"))
    ji, jt = j_cost_fns()
    ti, tt = t_cost_fns()
    jmode = JUTF(2, alpha=0.5) if mode == "utf" else mode
    tmode = TUTF(2, alpha=0.5) if mode == "utf" else mode
    jc = JAMPPI(jm.observation_space, jm.action_space,
                a_cov=1.5**2 * jnp.eye(1), inst_cost_fn=ji, term_cost_fn=jt,
                params_sampling=jmode, **kw)
    tc = TAMPPI(tm.observation_space, tm.action_space,
                a_cov=1.5**2 * torch.eye(1), inst_cost_fn=ti,
                term_cost_fn=tt, params_sampling=tmode, device="cpu", **kw)
    return jm, tm, jc, tc


def _dists(mode, rng):
    if mode in ("single", "extended"):
        n = 1 if mode == "single" else N_SAMPLES
        draws = rng.uniform(0.6, 1.3, size=(n, 2)).astype(np.float32)
        return _JStub(draws), _TStub(draws)
    if mode == "utf":
        return (JUniform(jnp.array([0.6, 0.6]), jnp.array([1.3, 1.3]),
                         event_ndims=1),
                TUniform(_t([0.6, 0.6]), _t([1.3, 1.3]), event_ndims=1))
    return None, None


@pytest.mark.parametrize("ext", [False, True], ids=["eps_noise",
                                                    "ext_actions"])
@pytest.mark.parametrize("mode", ["none", "single", "extended", "utf"])
def test_update_actions_matches_jax(mode, ext):
    rng = np.random.default_rng(0)
    jm, tm, jc, tc = _pair(mode)
    jdist, tdist = _dists(mode, rng)
    a_seq0 = rng.normal(size=(HORIZON, 1)).astype(np.float32)
    eps = (1.5 * rng.normal(size=(N_SAMPLES, HORIZON, 1))).astype(np.float32)
    state = np.array([[2.5, -0.3]], np.float32)
    ja = jc.init_state(a_seq0)
    ta = amppi_state_from_numpy(np.asarray(ja.a_seq), device="cpu")
    if ext:
        kw_j = dict(ext_actions=jnp.asarray(eps + a_seq0))
        kw_t = dict(ext_actions=_t(eps + a_seq0))
    else:
        kw_j, kw_t = (dict(eps_noise=jnp.asarray(eps)),
                      dict(eps_noise=_t(eps)))
    j_out = jc.update_actions(ja, jnp.asarray(state), jm, jdist, **kw_j)
    t_out = tc.update_actions(ta, _t(state), tm, tdist, **kw_t)
    want_states = ((5,) if mode == "utf" else ()) + (N_SAMPLES, HORIZON + 1,
                                                     2)
    assert t_out[2].shape == np.asarray(j_out[2]).shape == want_states
    np.testing.assert_allclose(t_out[1].numpy(), np.asarray(j_out[1]),
                               rtol=2e-4)
    np.testing.assert_allclose(t_out[2].numpy(), np.asarray(j_out[2]),
                               atol=1e-4)
    np.testing.assert_allclose(t_out[3].numpy(), np.asarray(j_out[3]),
                               atol=1e-6)
    np.testing.assert_allclose(t_out[4].numpy(), np.asarray(j_out[4]),
                               atol=1e-5)
    np.testing.assert_allclose(t_out[0].a_seq.numpy(),
                               np.asarray(j_out[0].a_seq), atol=1e-4)
    assert abs(float(t_out[4].sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("steps", [1, 3])
def test_roll_zero_fills_as_jax(steps):
    rng = np.random.default_rng(1)
    _, _, jc, tc = _pair("none")
    a_seq = rng.normal(size=(HORIZON, 1)).astype(np.float32)
    j = jc.roll(jc.init_state(a_seq), steps=steps)
    ta = tc.init_state(a_seq)
    t = tc.roll(ta, steps=steps)
    np.testing.assert_array_equal(t.a_seq.numpy(), np.asarray(j.a_seq))
    assert (t.a_seq[-steps:] == 0).all()
    # the input state is left as it was
    np.testing.assert_array_equal(ta.a_seq.numpy(), a_seq)


def test_sampled_modes_draw_from_the_generator():
    """'single' and 'extended' draw from the distribution with the
    caller's generator; the same seed gives the same update."""
    tm = TPendulum(uncertain_params=("length", "mass"))
    dist = TUniform(_t([0.6, 0.6]), _t([1.3, 1.3]), event_ndims=1)
    for mode in ("single", "extended"):
        _, _, _, tc = _pair(mode)
        outs = [tc.update_actions(tc.init_state(), _t([[2.5, -0.3]]), tm,
                                  dist, torch.Generator().manual_seed(7))
                for _ in range(2)]
        assert outs[0][2].shape == (N_SAMPLES, HORIZON + 1, 2)
        assert np.isfinite(outs[0][1].numpy()).all()
        np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())
    with pytest.raises(ValueError, match="params_sampling"):
        TAMPPI(tm.observation_space, tm.action_space, hz_len=4, n_samples=2,
               inst_cost_fn=t_cost_fns()[0], params_sampling="x",
               device="cpu")
