"""K1, the fused pendulum rollout costs: the port's plain version (what
the wrapper runs on CPU tensors, and what the CUDA kernel is held to on
the card) against the JAX Pallas kernel in interpret mode, and the
fused-hook `MultiDisco.forward` against the rollout forward in both
packages.

Tolerance: rtol 2e-5, atol 2e-4 (costs ~1e3 summed over the horizon;
the JAX package's own K1 test tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.experiments import build_pendulum_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.ops.pallas_rollout import (
    fused_pendulum_rollout_costs as j_rollout_costs,
)
from dust_tpu_torch.convert import stack_arrays_from_numpy
from dust_tpu_torch.ops import rollout as trollout

RTOL, ATOL = 2e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize(
    "n_params,n_act,n_pol,hz,state0",
    [(4, 16, 3, 12, (np.pi, 0.3)),      # small
     (3, 7, 3, 11, (0.2, 7.9))],        # odd shape, near the speed clamp
    ids=["small", "odd_near_clamp"],
)
def test_plain_k1_matches_jax_kernel(n_params, n_act, n_pol, hz, state0):
    rng = np.random.default_rng(n_act)
    # torques well outside +-2 exercise the clamp
    actions = (2.5 * rng.normal(size=(n_act, n_pol, hz, 1))).astype(np.float32)
    lengths = rng.uniform(0.6, 1.3, size=(n_params,)).astype(np.float32)
    masses = rng.uniform(0.6, 1.3, size=(n_params,)).astype(np.float32)
    s0 = np.asarray(state0, np.float32)

    j = j_rollout_costs(jnp.asarray(s0), jnp.asarray(actions),
                        jnp.asarray(lengths), jnp.asarray(masses), dt=0.05,
                        g=9.8, interpret=True)
    before = trollout.fused_pendulum_rollout_costs.launches
    t = trollout.fused_pendulum_rollout_costs(_t(s0), _t(actions),
                                              _t(lengths), _t(masses),
                                              dt=0.05, g=9.8)
    # CPU tensors take the plain version: no kernel launch is counted
    assert trollout.fused_pendulum_rollout_costs.launches == before
    assert t.shape == (n_params, n_act, n_pol)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        t.numpy(),
        trollout.pendulum_rollout_costs_plain(
            _t(s0), _t(actions), _t(lengths), _t(masses)).numpy(),
    )


def test_plain_k1_is_independent_of_the_model_step():
    """The plain K1 against the port's own model loop (the scan-rollout
    semantics it replaces), with per-draw parameters."""
    from dust_tpu_torch.models import PendulumModel

    rng = np.random.default_rng(3)
    actions = _t(2.5 * rng.normal(size=(5, 2, 9, 1)))
    lengths = _t(rng.uniform(0.6, 1.3, size=(3,)))
    masses = _t(rng.uniform(0.6, 1.3, size=(3,)))
    s0 = _t([3.0, -0.5])
    model = PendulumModel(uncertain_params=("length", "mass"))
    params = {"length": lengths.reshape(3, 1, 1, 1),
              "mass": masses.reshape(3, 1, 1, 1)}
    states = s0.expand(3, 5, 2, 2)
    cost = torch.zeros(3, 5, 2)
    for t in range(9):
        cost = cost + 50.0 * (torch.cos(states[..., 0]) - 1) ** 2 \
            + states[..., 1] ** 2
        states = model.step(states, actions[:, :, t, :], params)
    cost = cost + 50.0 * (torch.cos(states[..., 0]) - 1) ** 2 \
        + states[..., 1] ** 2
    np.testing.assert_allclose(
        trollout.pendulum_rollout_costs_plain(s0, actions, lengths,
                                              masses).numpy(),
        cost.numpy(), rtol=RTOL, atol=ATOL,
    )


class _JStub:
    def __init__(self, draws, log_p):
        self.draws, self.log_p = jnp.asarray(draws), jnp.asarray(log_p)

    def sample(self, key, shape):
        return self.draws

    def log_prob(self, x):
        return self.log_p


class _TStub:
    def __init__(self, draws, log_p):
        self.draws, self.log_p = _t(draws), _t(log_p)

    def sample(self, generator, shape):
        return self.draws

    def log_prob(self, x):
        return self.log_p


def _config(fused):
    cfg = load_config("demo/pendulum_config.yaml")
    cfg["exp_params"].update(horizon=12, action_samples=9, params_samples=3,
                             n_particles=3, fused_rollout=fused)
    return cfg


def _stack_arrays(js):
    arrays = {
        "init_policies": js.init_policies,
        "policies_prior.locs": js.policies_prior.locs,
        "policies_prior.scale_tril": js.policies_prior.scale_tril,
        "policies_prior.logits": js.policies_prior.logits,
        "dynamics_prior.low": js.dynamics_prior.low,
        "dynamics_prior.high": js.dynamics_prior.high,
        "init_state": js.init_state,
    }
    if js.mpf_init is not None:
        arrays["mpf_init"] = js.mpf_init
    return {k: np.asarray(v) for k, v in arrays.items()}


@pytest.mark.parametrize("case", ["dust", "svmpc"])
def test_forward_fused_hook_matches_rollout_in_both_packages(case):
    rng = np.random.default_rng(4)
    eps = (2.0 * rng.normal(size=(9, 3, 12, 1))).astype(np.float32)
    draws = rng.uniform(0.6, 1.3, size=(3, 2)).astype(np.float32)
    log_p = rng.normal(size=(3,)).astype(np.float32)

    outs = {}
    for fused in (False, True):
        cfg = _config(fused)
        js = j_build(cfg, jax.random.key(0), case=case)
        ts = stack_arrays_from_numpy(_stack_arrays(js), cfg, device="cpu",
                                     case=case)
        assert (js.controller.fused_state_costs is None) == (not fused)
        assert (ts.controller.fused_state_costs is None) == (not fused)
        jd = js.controller.init_state(js.init_policies)
        td = ts.controller.init_state(ts.init_policies)
        jpd = _JStub(draws, log_p) if case == "dust" else None
        tpd = _TStub(draws, log_p) if case == "dust" else None
        j_out = js.controller.forward(
            jd, js.init_state.reshape(1, -1), js.model, jpd,
            jax.random.key(1), eps_noise=jnp.asarray(eps))
        t_out = ts.controller.forward(
            td, ts.init_state.reshape(1, -1), ts.model, tpd, None,
            eps_noise=_t(eps))
        assert (t_out[2] is None) == fused
        outs[("jax", fused)] = [np.asarray(j_out[1]), np.asarray(j_out[4]),
                                np.asarray(j_out[0].a_mat),
                                np.asarray(j_out[0].a_mix)]
        outs[("torch", fused)] = [t_out[1].numpy(), t_out[4].numpy(),
                                  t_out[0].a_mat.numpy(),
                                  t_out[0].a_mix.numpy()]

    # Costs (~2.6e3 here) and weights hold at the K1 tolerance. The plan
    # update weights 2-sigma noise by exp(-(c - c_min) / temp): a one-ulp
    # cost difference (the rollout path rounds dt * (...) where K1 folds
    # dt into its coefficients) moves the weights by ~5e-4 relative, so
    # a_mat and a_mix are held at the closed loop's per-step tolerance.
    ref = outs[("jax", False)]
    for key, got in outs.items():
        for name, a, b in zip(("costs", "omega", "a_mat", "a_mix"), got,
                              ref):
            tol = (dict(rtol=RTOL, atol=ATOL) if name in ("costs", "omega")
                   else dict(rtol=1e-3, atol=5e-4))
            np.testing.assert_allclose(a, b, err_msg=f"{key} {name}", **tol)


def test_hook_rejects_unknown_parameter_columns():
    from dust_tpu_torch.models import PendulumModel

    hook = trollout.make_fused_pendulum_state_costs(PendulumModel())
    with pytest.raises(ValueError, match="length/mass"):
        hook(_t([0.0, 0.0]), torch.zeros(2, 1, 3, 1),
             {"g": torch.ones(1, 1, 1, 1)})


@pytest.mark.parametrize("columns", [("length", "mass"), ("length",),
                                     ("mass",), ()],
                         ids=["length_and_mass", "length_only", "mass_only",
                              "no_params"])
def test_hook_on_draw_column_views_matches_jax_hook(columns):
    """The hook's plain path on `draws[:, i]` column views, as
    `MultiDisco._sample_params` builds them (stride 2), against JAX's
    hook on the same arrays; an absent column (and params=None) takes the
    model's default, which the port passes as a number."""
    from dust_tpu.models import PendulumModel as JPendulum
    from dust_tpu.ops.pallas_rollout import (
        make_fused_pendulum_state_costs as j_make_hook,
    )
    from dust_tpu_torch.models import PendulumModel

    rng = np.random.default_rng(11)
    n_params = 5
    actions = (2.5 * rng.normal(size=(9, 3, 12, 1))).astype(np.float32)
    draws = rng.uniform(0.6, 1.3, size=(n_params, 2)).astype(np.float32)
    state = np.asarray([[2.9, -0.4]], np.float32)
    kw = dict(mass=1.1, length=0.9)
    t_draws = _t(draws)
    t_params = {k: t_draws[:, i].reshape(n_params, 1, 1, 1)
                for i, k in enumerate(("length", "mass")) if k in columns}
    j_params = {k: jnp.asarray(draws)[:, i].reshape(n_params, 1, 1, 1)
                for i, k in enumerate(("length", "mass")) if k in columns}
    for col in t_params.values():
        assert col.reshape(-1).stride(0) == 2
    got = trollout.make_fused_pendulum_state_costs(PendulumModel(**kw))(
        _t(state), _t(actions), t_params or None)
    want = j_make_hook(JPendulum(**kw), interpret=True)(
        jnp.asarray(state), jnp.asarray(actions), j_params or None)
    assert got.shape == (9, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n_params", [17, 11, 8, 3, 1])
def test_draw_mean_plain_equals_torch_mean(n_params):
    """The kernel's draw mean (`draw_mean_plain`: the draws added in
    order, times 1 / n_params) against torch's mean over the draws, at
    rtol 1e-6 (torch may add in another order and divide); the mean entry
    on CPU tensors is that plain version."""
    rng = np.random.default_rng(20 + n_params)
    s0 = _t([3.0, 0.0])
    actions = _t(2.5 * rng.normal(size=(16, 3, 30, 1)))
    lengths = _t(rng.uniform(0.6, 1.3, size=(n_params,)))
    masses = _t(rng.uniform(0.6, 1.3, size=(n_params,)))
    costs = trollout.pendulum_rollout_costs_plain(s0, actions, lengths,
                                                  masses)
    mean = trollout.draw_mean_plain(costs)
    np.testing.assert_allclose(mean.numpy(), costs.mean(0).numpy(),
                               rtol=1e-6, atol=0)
    before = trollout.fused_pendulum_rollout_costs.launches
    got = trollout.fused_pendulum_rollout_cost_mean(s0, actions, lengths,
                                                    masses)
    assert trollout.fused_pendulum_rollout_costs.launches == before
    np.testing.assert_array_equal(got.numpy(), mean.numpy())


def test_hook_makes_no_filled_tensor_and_reads_columns_in_place(monkeypatch):
    """With both columns in `params` the hook calls no `torch.full` (nor
    for the defaults: they travel as numbers), and the kernel's column
    arguments address the caller's draws through their stride, with no
    copy; a column of another dtype is refused, not converted."""
    from dust_tpu_torch.models import PendulumModel

    calls = []
    full = torch.full

    def counting_full(*args, **kwargs):
        calls.append(args)
        return full(*args, **kwargs)

    monkeypatch.setattr(torch, "full", counting_full)
    rng = np.random.default_rng(12)
    draws = _t(rng.uniform(0.6, 1.3, size=(4, 2)))
    params = {k: draws[:, i].reshape(4, 1, 1, 1)
              for i, k in enumerate(("length", "mass"))}
    hook = trollout.make_fused_pendulum_state_costs(PendulumModel())
    actions = _t(rng.normal(size=(6, 3, 8, 1)))
    out = hook(_t([[1.0, 0.5]]), actions, params)
    assert out.shape == (6, 3) and torch.isfinite(out).all()
    hook(_t([[1.0, 0.5]]), actions, None)
    assert calls == []

    for i, k in enumerate(("length", "mass")):
        ptr, stride, value = trollout._kernel_column(
            params[k].reshape(-1), draws.device)
        assert (ptr, stride, value) == (draws.data_ptr() + 4 * i, 2, 0.0)
    assert trollout._kernel_column(1.25, draws.device) == (0, 0, 1.25)
    with pytest.raises(ValueError, match="float32"):
        trollout._kernel_column(params["mass"].reshape(-1).double(),
                                draws.device)
