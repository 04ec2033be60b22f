"""The cart-pole and skid-steer models and the derivative helpers of
`dust_tpu_torch` against `dust_tpu`'s, on the same states, actions and
parameters (atol 1e-5), plus tests/test_controller_base.py's quadratic
and finite-difference cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.controllers.base import get_hessian as j_hessian
from dust_tpu.controllers.base import get_jacobian as j_jacobian
from dust_tpu.controllers.base import linearize_model as j_linearize
from dust_tpu.models import CartPoleModel as JCartPole
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.models import SkidSteerRobot as JSkid
from dust_tpu_torch.controllers.base import get_hessian as t_hessian
from dust_tpu_torch.controllers.base import get_jacobian as t_jacobian
from dust_tpu_torch.controllers.base import linearize_model as t_linearize
from dust_tpu_torch.models import CartPoleModel as TCartPole
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.models import SkidSteerRobot as TSkid

ATOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _cartpole_inputs(rng, n=64):
    states = np.stack([rng.uniform(-2, 2, n), rng.normal(size=n),
                       rng.uniform(-0.5, 0.5, n), rng.normal(size=n)],
                      1).astype(np.float32)
    states[:4, 1] = 0.0  # sign(0) of the cart friction
    actions = rng.uniform(-1.5, 1.5, size=(n, 1)).astype(np.float32)
    return states, actions


@pytest.mark.parametrize("sampled", [False, True])
def test_cartpole_step_matches_jax(sampled):
    rng = np.random.default_rng(0)
    states, actions = _cartpole_inputs(rng)
    kw = dict(dt=0.02)
    params_np = None
    if sampled:
        kw["uncertain_params"] = ("length", "mass_pole")
        params_np = {"length": rng.uniform(0.5, 1.5, (64, 1)),
                     "mass_pole": rng.uniform(0.05, 0.3, (64, 1))}
    jm, tm = JCartPole(**kw), TCartPole(device="cpu", **kw)
    jp = (None if params_np is None else
          {k: jnp.asarray(v, jnp.float32) for k, v in params_np.items()})
    tp = (None if params_np is None else
          {k: _t(v) for k, v in params_np.items()})
    j = jm.step(jnp.asarray(states), jnp.asarray(actions), jp)
    t = tm.step(_t(states), _t(actions), tp)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    assert tm.action_space.dim == 1 and tm.observation_space.dim == 4
    np.testing.assert_array_equal(tm.observation_space.high,
                                  jm.observation_space.high)


@pytest.mark.parametrize("sampled", [False, True])
def test_skid_steer_step_matches_jax(sampled):
    rng = np.random.default_rng(1)
    n = 64
    states = rng.normal(size=(n, 5)).astype(np.float32)
    # wheel speeds beyond the +-0.5 clamp
    actions = rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)
    kw = {}
    params_np = None
    if sampled:
        kw["uncertain_params"] = ("x_icr", "wheel_radius", "axial_distance")
        params_np = {"x_icr": rng.uniform(0.1, 0.3, (n, 1)),
                     "wheel_radius": rng.uniform(0.05, 0.08, (n, 1)),
                     "axial_distance": rng.uniform(0.4, 0.55, (n, 1))}
    jm = JSkid(delta_t=0.1, **kw)
    tm = TSkid(delta_t=0.1, device="cpu", **kw)
    jp = (None if params_np is None else
          {k: jnp.asarray(v, jnp.float32) for k, v in params_np.items()})
    tp = (None if params_np is None else
          {k: _t(v) for k, v in params_np.items()})
    j = jm.step(jnp.asarray(states), jnp.asarray(actions), jp)
    t = tm.step(_t(states), _t(actions), tp)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL)
    # the clamp: wheel speeds of +-2 move the robot as +-0.5 do
    fast = tm.step(_t(states[:1]), _t([[2.0, -2.0]]))
    np.testing.assert_array_equal(
        fast.numpy(), tm.step(_t(states[:1]), _t([[0.5, -0.5]])).numpy())


def test_models_run_where_they_were_built():
    with pytest.raises(ValueError, match="built for"):
        TCartPole(device="cpu").step(_t(np.zeros((1, 4))).to("meta"),
                                     _t([[0.0]]))


def test_jacobian_and_hessian_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(3, 2, 2)).astype(np.float32)
    x = rng.normal(size=(2, 2)).astype(np.float32)

    def j_fn(v):
        return jnp.tanh(jnp.einsum("kij,ij->k", jnp.asarray(a), v)) * v[0, 0]

    def t_fn(v):
        return torch.tanh(torch.einsum("kij,ij->k", _t(a), v)) * v[0, 0]

    jj = np.asarray(j_jacobian(j_fn, jnp.asarray(x)))
    tj = t_jacobian(t_fn, _t(x)).numpy()
    assert tj.shape == jj.shape == (3, 4)
    np.testing.assert_allclose(tj, jj, atol=ATOL)
    jh = np.asarray(j_hessian(lambda v: jnp.sum(jnp.sin(v) * v**2),
                              jnp.asarray(x)))
    th = t_hessian(lambda v: (torch.sin(v) * v**2).sum(), _t(x)).numpy()
    assert th.shape == jh.shape == (4, 4)
    np.testing.assert_allclose(th, jh, atol=ATOL)


def test_jacobian_and_hessian_of_quadratics():
    a = _t([[2.0, 1.0], [0.0, 3.0]])
    np.testing.assert_allclose(t_jacobian(lambda x: a @ x,
                                          _t([1.0, -1.0])).numpy(),
                               a.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        t_hessian(lambda x: (x**2).sum(), _t([1.0, 2.0, 3.0])).numpy(),
        2 * np.eye(3), atol=1e-6)


@pytest.mark.parametrize("model", ["pendulum", "cartpole", "skid_steer"])
def test_linearize_model_matches_jax(model):
    rng = np.random.default_rng(3)
    if model == "pendulum":
        jm, tm = JPendulum(), TPendulum()
        s, a = np.array([0.1, 0.0], np.float32), np.array([0.5], np.float32)
    elif model == "cartpole":
        jm, tm = JCartPole(dt=0.02), TCartPole(dt=0.02, device="cpu")
        s, a = _cartpole_inputs(rng, 1)
        s, a = s[0], a[0] * 0.5
    else:
        jm, tm = JSkid(delta_t=0.1), TSkid(delta_t=0.1, device="cpu")
        s = rng.normal(size=5).astype(np.float32)
        a = np.array([0.3, -0.1], np.float32)
    ja, jb = j_linearize(jm, jnp.asarray(s), jnp.asarray(a))
    ta, tb = t_linearize(tm, _t(s), _t(a))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL)
    if model == "pendulum":
        # finite differences on A (tests/test_controller_base.py)
        eps = 1e-4
        for i in range(2):
            ds = torch.zeros(2)
            ds[i] = eps
            fd = (tm.step(_t(s) + ds, _t(a)) - tm.step(_t(s) - ds, _t(a))) \
                / (2 * eps)
            np.testing.assert_allclose(ta[:, i].numpy(), fd.numpy(),
                                       atol=1e-2)
