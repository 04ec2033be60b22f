"""The point-mass navigation model: the port's `Particle` against
`dust_tpu`'s on the same numpy inputs — the Euler step with the crash
freeze and the speed clamp, both control types, the built-in costs, the
cost weights, the map coordinates — and the mass gradient of the MPF's
observation likelihood through `step` (`torch.func.grad` against
`jax.grad`).

Tolerances: the step and the costs at rtol 1e-6 (the same float32
operations in the same order); the likelihood gradient at rtol 1e-5."""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.inference import GaussianLikelihood as JLik
from dust_tpu.inference import MPF as JMPF
from dust_tpu.models import Particle as JParticle
from dust_tpu_torch.inference import MPF as TMPF
from dust_tpu_torch.inference import GaussianLikelihood as TLik
from dust_tpu_torch.models import Particle as TParticle

ENV = dict(
    dt=0.015, control_type="acceleration", can_crash=True,
    with_obstacle=True, deterministic=True, obst_preset="grid_4x4",
    obst_width=2.1, max_speed=5.0, max_accel=10.0, map_cell_size=0.1,
    map_size=[22, 22], map_type="direct", target_state=[9.0, 9.0, 0, 0],
    init_state=[-9.0, -9.0, 0, 0],
    cost_params=dict(w_qpos=0.5, w_qvel=0.25, w_ctrl=0.2, w_obs=1.0e6,
                     w_qpos_T=1.0e3, w_qvel_T=0.1),
)
TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _models(**over):
    env = dict(ENV, **over)
    return (JParticle(uncertain_params=["mass"], mass=2.0, **env),
            TParticle(uncertain_params=["mass"], mass=2.0, device="cpu",
                      **env))


def _states(rng, n=600):
    # positions across the map (many inside obstacles and walls), some
    # velocities beyond the clamp
    pos = rng.uniform(-11.5, 11.5, size=(n, 2))
    vel = rng.uniform(-6.0, 6.0, size=(n, 2))
    return np.concatenate([pos, vel], 1).astype(np.float32)


@pytest.mark.parametrize("over", [
    {}, dict(can_crash=False), dict(with_obstacle=False, can_crash=False),
])
def test_step_matches_jax(rng, over):
    jm, tm = _models(**over)
    s = _states(rng)
    a = (15.0 * rng.normal(size=(s.shape[0], 2))).astype(np.float32)
    masses = rng.uniform(1.5, 3.0, size=(s.shape[0], 1)).astype(np.float32)
    for params in (None, "cols"):
        jp = None if params is None else {"mass": jnp.asarray(masses)}
        tp = None if params is None else {"mass": _t(masses)}
        want = np.asarray(jm.step(jnp.asarray(s), jnp.asarray(a), jp))
        got = tm.step(_t(s), _t(a), tp).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    # speed clamp and (with crash) some particles frozen in place
    assert np.abs(got[:, 2:]).max() <= 5.0
    frozen = np.all(got == s, axis=1)
    if over:
        assert not frozen.any()
    else:
        assert frozen.sum() > 20


def test_step_velocity_control_matches_jax(rng):
    env = dict(dt=0.05, control_type="velocity", deterministic=True,
               max_speed=2.0)
    jm = JParticle(uncertain_params=["mass"], **env)
    tm = TParticle(uncertain_params=["mass"], device="cpu", **env)
    s = rng.normal(size=(50, 2)).astype(np.float32)
    a = (3.0 * rng.normal(size=(50, 2))).astype(np.float32)
    np.testing.assert_allclose(
        tm.step(_t(s), _t(a)).numpy(),
        np.asarray(jm.step(jnp.asarray(s), jnp.asarray(a))), **TOL)
    assert tm.action_space.high.tolist() == [2.0, 2.0]


def test_stochastic_step_draws_from_the_generator(rng):
    _, tm = _models(deterministic=False, with_obstacle=False,
                    can_crash=False, noise_std=[0.1, 0.1])
    s, a = _t(_states(rng, 8)), _t(rng.normal(size=(8, 2)))
    one = tm.step(s, a, generator=torch.Generator().manual_seed(3))
    two = tm.step(s, a, generator=torch.Generator().manual_seed(3))
    other = tm.step(s, a, generator=torch.Generator().manual_seed(4))
    plain = tm.step(s, a)
    assert torch.equal(one, two) and not torch.equal(one, other)
    assert not torch.equal(one, plain)
    # the positions take the old velocity: noise reaches only the speeds
    np.testing.assert_array_equal(one[:, :2].numpy(), plain[:, :2].numpy())


def test_costs_and_weights_match_jax(rng):
    jm, tm = _models()
    s = _states(rng).reshape(6, 100, 4)
    a = rng.normal(size=(6, 100, 2)).astype(np.float32)
    np.testing.assert_allclose(
        tm.default_inst_cost(_t(s), _t(a)).numpy(),
        np.asarray(jm.default_inst_cost(jnp.asarray(s), jnp.asarray(a))),
        **TOL)
    np.testing.assert_allclose(
        tm.default_inst_cost(_t(s)).numpy(),
        np.asarray(jm.default_inst_cost(jnp.asarray(s))), **TOL)
    np.testing.assert_allclose(
        tm.default_term_cost(_t(s)).numpy(),
        np.asarray(jm.default_term_cost(jnp.asarray(s))), **TOL)
    for name in ("w_state", "w_ctrl", "w_term", "target", "init_state"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    assert tm.w_obs == float(jm.w_obs)
    for coord in ([0.0, 0.0], [-10.95, 3.33]):
        np.testing.assert_allclose(tm.to_map_coord(coord).numpy(),
                                   np.asarray(jm.to_map_coord(coord)),
                                   rtol=1e-6)
    jd, td = (JParticle(), TParticle(device="cpu"))  # default weights: all 1.0
    np.testing.assert_array_equal(td.w_term.numpy(), np.asarray(jd.w_term))


@pytest.mark.parametrize("log_space", [True, False])
@pytest.mark.parametrize("start", ["free", "inside a wall", "at the clamp"])
def test_mass_likelihood_gradient_matches_jax_grad(rng, log_space, start):
    """MPF._grad_lik differentiates the observation likelihood through
    `Particle.step`: `torch.func.grad` against `jax.grad`, with the
    acceleration clip active for some particles, the crash freeze (zero
    gradient) inside a wall, and the speed clip at the clamp."""
    jm, tm = _models()
    obs = {"free": [-9.0, -9.0, 0.4, -0.2],
           "inside a wall": [10.95, 0.3, 0.4, -0.2],
           "at the clamp": [0.0, 0.0, 4.96, -4.96]}[start]
    new_obs = np.array(obs, np.float32) + np.array(
        [0.01, -0.01, 0.1, -0.15], np.float32)
    x = rng.uniform(0.5, 3.0, size=(40, 1)).astype(np.float32)
    if log_space:
        x = np.log(x)
    action = np.array([25.0, -6.0], np.float32)
    jlik = JLik(obs_std=0.1, model=jm, log_space=log_space)
    tlik = TLik(obs_std=0.1, model=tm, log_space=log_space)
    jmpf, tmpf = JMPF(likelihood=jlik), TMPF(likelihood=tlik)
    jms = jmpf.init_state(x, jnp.asarray(obs, jnp.float32), 2, bw=0.2)
    tms = tmpf.init_state(x, _t(obs), 2, bw=0.2)
    jms = jms.replace(lik=jlik.condition(jms.lik, jnp.asarray(action),
                                         jnp.asarray(new_obs)))
    tms = replace(tms, lik=tlik.condition(tms.lik, _t(action), _t(new_obs)))
    want = np.asarray(jmpf._grad_lik(jms, jnp.asarray(x)))
    got = tmpf._grad_lik(tms, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if start == "inside a wall":
        assert not np.any(got)
    else:
        assert np.any(got)
