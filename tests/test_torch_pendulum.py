"""Port pendulum model and MultiDisco against `dust_tpu`.

Randomness is injected identically on both sides: action noise through
`forward(eps_noise=)` / `ext_actions`, parameter draws through stub
distributions that return pre-drawn numpy arrays.

Tolerances: the model step at rtol 1e-5, atol 1e-6 (elementwise float32);
MultiDisco outputs at rtol 2e-5, atol 2e-4 (30-step rollouts summed into
costs of size ~1e3, the K1 test tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.controllers import MultiDisco as JDisco
from dust_tpu.experiments import pendulum_cost_fns as j_cost_fns
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu_torch.controllers import MultiDisco as TDisco
from dust_tpu_torch.experiments import pendulum_cost_fns as t_cost_fns
from dust_tpu_torch.models import PendulumModel as TPendulum

RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _JStub:
    """Parameter distribution returning fixed draws (JAX side)."""

    def __init__(self, draws, log_p):
        self.draws, self.log_p = jnp.asarray(draws), jnp.asarray(log_p)

    def sample(self, key, shape):
        return self.draws

    def log_prob(self, x):
        return self.log_p


class _TStub:
    """The same draws for the port (generator in place of the key)."""

    def __init__(self, draws, log_p):
        self.draws, self.log_p = _t(draws), _t(log_p)

    def sample(self, generator, shape):
        return self.draws

    def log_prob(self, x):
        return self.log_p


@pytest.mark.parametrize("gym_v0_compat", [False, True])
def test_pendulum_step_at_clamp_edges(gym_v0_compat):
    """Torques beyond +-2 and speeds pushed past +-8, per-row params."""
    rng = np.random.default_rng(0)
    n = 64
    states = np.stack([rng.uniform(-np.pi, np.pi, n),
                       rng.choice([-7.95, 7.95, 0.3], n)], 1).astype(np.float32)
    actions = rng.uniform(-5.0, 5.0, size=(n, 1)).astype(np.float32)
    length = rng.uniform(0.6, 1.3, size=(n, 1)).astype(np.float32)
    mass = rng.uniform(0.6, 1.3, size=(n, 1)).astype(np.float32)
    jm = JPendulum(uncertain_params=("length", "mass"),
                   gym_v0_compat=gym_v0_compat)
    tm = TPendulum(uncertain_params=("length", "mass"),
                   gym_v0_compat=gym_v0_compat)
    j = jm.step(jnp.asarray(states), jnp.asarray(actions),
                {"length": jnp.asarray(length), "mass": jnp.asarray(mass)})
    t = tm.step(_t(states), _t(actions), {"length": _t(length),
                                          "mass": _t(mass)})
    np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5, atol=1e-6)
    assert np.abs(_np(t)[:, 1]).max() <= 8.0
    # nominal parameters and the simulator's g = 10
    for g in (9.8, 10.0):
        j = JPendulum(g=g).step(jnp.asarray(states), jnp.asarray(actions))
        t = TPendulum(g=g).step(_t(states), _t(actions))
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(_np(TPendulum.get_obs(_t(states))),
                               np.asarray(JPendulum.get_obs(states)),
                               rtol=1e-5, atol=1e-6)


def _pair(mode, n_pol=3, hz=12, n_act=16, n_params=4, ctrl_penalty=1.0,
          log_space=False):
    kw = dict(hz_len=hz, n_policies=n_pol, action_samples=n_act,
              params_samples=n_params, temperature=0.7,
              ctrl_penalty=ctrl_penalty,
              params_sampling=True if mode == "sampled" else "none",
              params_log_space=log_space)
    jm = JPendulum(uncertain_params=("length", "mass"))
    tm = TPendulum(uncertain_params=("length", "mass"))
    ji, jt = j_cost_fns()
    ti, tt = t_cost_fns()
    jc = JDisco(jm.observation_space, jm.action_space,
                a_cov=4.0 * jnp.eye(1), inst_cost_fn=ji, term_cost_fn=jt,
                **kw)
    tc = TDisco(tm.observation_space, tm.action_space,
                a_cov=4.0 * torch.eye(1), inst_cost_fn=ti, term_cost_fn=tt,
                device="cpu", **kw)
    return jm, tm, jc, tc


@pytest.mark.parametrize("ctrl_penalty", [1.0, 0.6])
@pytest.mark.parametrize("mode", ["none", "sampled"])
def test_multidisco_forward_and_step(mode, ctrl_penalty):
    rng = np.random.default_rng(1)
    jm, tm, jc, tc = _pair(mode, ctrl_penalty=ctrl_penalty)
    init = rng.normal(size=(3, 12, 1)).astype(np.float32)
    eps = (2.0 * rng.normal(size=(16, 3, 12, 1))).astype(np.float32)
    draws = rng.uniform(0.6, 1.3, size=(4, 2)).astype(np.float32)
    log_p = rng.normal(size=(4,)).astype(np.float32)
    state = np.array([[2.9, -0.4]], np.float32)

    jd = jc.init_state(init)
    td = tc.init_state(init)
    j_out = jc.forward(jd, jnp.asarray(state), jm, _JStub(draws, log_p),
                       jax.random.key(0), eps_noise=jnp.asarray(eps))
    t_out = tc.forward(td, _t(state), tm, _TStub(draws, log_p), None,
                       eps_noise=_t(eps))
    for name, i in (("costs", 1), ("states", 2), ("actions", 3),
                    ("omega", 4)):
        np.testing.assert_allclose(_np(t_out[i]), np.asarray(j_out[i]),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    if mode == "sampled":
        np.testing.assert_allclose(_np(t_out[5]), np.asarray(j_out[5]))
    for field in ("a_seq", "a_mat", "a_mix"):
        np.testing.assert_allclose(_np(getattr(t_out[0], field)),
                                   np.asarray(getattr(j_out[0], field)),
                                   rtol=RTOL, atol=ATOL, err_msg=field)

    for strategy in ("argmax", "average"):
        j_next, j_act = jc.step(j_out[0], strategy=strategy)
        t_next, t_act = tc.step(t_out[0], strategy=strategy)
        np.testing.assert_allclose(_np(t_act), np.asarray(j_act),
                                   rtol=RTOL, atol=ATOL)
        for field in ("a_seq", "a_mat"):
            np.testing.assert_allclose(_np(getattr(t_next, field)),
                                       np.asarray(getattr(j_next, field)),
                                       rtol=RTOL, atol=ATOL)


def test_multidisco_ext_actions_log_space_params():
    """ext_actions (the SVMPC likelihood's path) with log-space draws."""
    rng = np.random.default_rng(2)
    jm, tm, jc, tc = _pair("sampled", log_space=True)
    acts = (2.0 * rng.normal(size=(16, 3, 12, 1))).astype(np.float32)
    draws = np.log(rng.uniform(0.6, 1.3, size=(4, 2))).astype(np.float32)
    log_p = rng.normal(size=(4,)).astype(np.float32)
    state = np.array([[0.4, 7.9]], np.float32)
    j_out = jc.forward(jc.init_state(), jnp.asarray(state), jm,
                       _JStub(draws, log_p), jax.random.key(0),
                       ext_actions=jnp.asarray(acts))
    t_out = tc.forward(tc.init_state(), _t(state), tm, _TStub(draws, log_p),
                       None, ext_actions=_t(acts))
    np.testing.assert_allclose(_np(t_out[1]), np.asarray(j_out[1]),
                               rtol=RTOL, atol=ATOL)
    # the plan update weights by softmax(-costs / temp): cost differences of
    # ~1e-3 absolute (costs ~1e3 near the speed clamp) become weight
    # differences of ~1e-3 relative, so the plan is held at the closed
    # loop's per-step tolerance
    np.testing.assert_allclose(_np(t_out[0].a_mat), np.asarray(j_out[0].a_mat),
                               rtol=1e-3, atol=5e-4)


def test_multidisco_rejects_utf_and_bad_modes():
    tm = TPendulum()
    ti, tt = t_cost_fns()
    kw = dict(hz_len=4, n_policies=1, action_samples=2, inst_cost_fn=ti,
              term_cost_fn=tt, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        TDisco(tm.observation_space, tm.action_space, params_sampling="utf",
               **kw)
    with pytest.raises(ValueError):
        TDisco(tm.observation_space, tm.action_space, params_sampling="x",
               **kw)
