"""The port's SVMPC against `dust_tpu`'s: `svgd_step(noise=)`,
`get_weights`, `roll`, `update_prior` and `forward`, with and without
`reference_compat`, on both kernel paths. Action noise and parameter draws
are injected; the bandwidth is the Silverman rule of the same particles.

Tolerances: costs at rtol 2e-5, atol 2e-4 (the K1 tolerance); particles
after a Stein step at the closed loop's per-step tolerance, rtol 1e-3,
atol 5e-4 (the likelihood gradient weights samples by softmax(-costs),
which turns one-ulp cost differences into ~1e-4 relative weight
differences); weights, rolls and priors of identical particles at
rtol 1e-5, atol 1e-6. With Adam (optax.adam(0.1)) theta and the first
moment at the Stein step's tolerance, the second moment (squares of the
gradients) at twice its rtol."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dust_tpu.controllers import MultiDisco as JDisco
from dust_tpu.distributions import GMM as JGMM
from dust_tpu.experiments import pendulum_cost_fns as j_cost_fns
from dust_tpu.inference import ExponentiatedUtility as JExpUtil
from dust_tpu.inference import SVMPC as JSVMPC
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.ops.bandwidth import silvermans_rule as j_silverman
from dust_tpu_torch.controllers import MultiDisco as TDisco
from dust_tpu_torch.distributions import GMM as TGMM
from dust_tpu_torch.experiments import pendulum_cost_fns as t_cost_fns
from dust_tpu_torch.inference import ExponentiatedUtility as TExpUtil
from dust_tpu_torch.inference import SVMPC as TSVMPC
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.ops.bandwidth import silvermans_rule as t_silverman

M, H, N_S, N_P = 4, 8, 16, 3
STEP_TOL = dict(rtol=1e-3, atol=5e-4)
EXACT_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


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


def _pair(kernel, reference_compat, weighted_prior=False,
          roll_strategy="repeat", adam_lr=None):
    kw = dict(hz_len=H, n_policies=M, action_samples=N_S,
              params_samples=N_P, params_sampling=True)
    jm = JPendulum(uncertain_params=("length", "mass"))
    tm = TPendulum(uncertain_params=("length", "mass"))
    jc = JDisco(jm.observation_space, jm.action_space,
                a_cov=4.0 * jnp.eye(1), inst_cost_fn=j_cost_fns()[0],
                term_cost_fn=j_cost_fns()[1], **kw)
    tc = TDisco(tm.observation_space, tm.action_space,
                a_cov=4.0 * torch.eye(1), inst_cost_fn=t_cost_fns()[0],
                term_cost_fn=t_cost_fns()[1], device="cpu", **kw)
    skw = dict(kernel=kernel, n_particles=M, n_steps=1,
               reference_compat=reference_compat,
               weighted_prior=weighted_prior, roll_strategy=roll_strategy)
    if adam_lr is None:
        jopt, topt = dict(optimizer=optax.sgd(2.0)), dict(lr=2.0)
    else:
        jopt = dict(optimizer=optax.adam(adam_lr))
        topt = dict(optimizer="adam", lr=adam_lr)
    js = JSVMPC(JExpUtil(alpha=1.0, n_samples=N_S, controller=jc, model=jm),
                **jopt, **skw)
    ts = TSVMPC(TExpUtil(alpha=1.0, n_samples=N_S, controller=tc, model=tm),
                **topt, **skw)
    return js, ts


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        theta=(2.0 * rng.normal(size=(M, H, 1))).astype(np.float32),
        noise=rng.normal(size=(N_S, M, H, 1)).astype(np.float32),
        draws=rng.uniform(0.6, 1.3, size=(N_P, 2)).astype(np.float32),
        log_p=rng.normal(size=(N_P,)).astype(np.float32),
        state=np.array([[3.0, 0.0]], np.float32),
    )


@pytest.mark.parametrize("reference_compat", [False, True])
@pytest.mark.parametrize("kernel", ["rbf", "message_passing"])
def test_svgd_step_and_forward(kernel, reference_compat):
    inp = _inputs()
    js, ts = _pair(kernel, reference_compat)
    jprior = JGMM.from_cov(inp["theta"], jnp.ones(M), 4.0 * jnp.eye(1))
    tprior = TGMM.from_cov(inp["theta"], torch.ones(M), 4.0 * torch.eye(1))
    jsv = js.init_state(inp["theta"], jprior)
    tsv = ts.init_state(_t(inp["theta"]), tprior)
    jd = js.controller.init_state(inp["theta"])
    td = ts.controller.init_state(_t(inp["theta"]))

    jbw = j_silverman(jsv.theta)
    tbw = t_silverman(tsv.theta)
    np.testing.assert_allclose(tbw.numpy(), np.asarray(jbw), **EXACT_TOL)

    jsv, jd, jc = js.svgd_step(jsv, jd, jnp.asarray(inp["state"]),
                               _JStub(inp["draws"], inp["log_p"]),
                               jax.random.key(0), jbw,
                               noise=jnp.asarray(inp["noise"]))
    tsv, td, tc = ts.svgd_step(tsv, td, _t(inp["state"]),
                               _TStub(inp["draws"], inp["log_p"]), None, tbw,
                               noise=_t(inp["noise"]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(tsv.theta.numpy(), np.asarray(jsv.theta),
                               **STEP_TOL)
    np.testing.assert_allclose(td.a_mat.numpy(), np.asarray(jd.a_mat),
                               **STEP_TOL)

    # forward from identical particles and costs: weights, selection,
    # roll and prior refresh, twice so the compat live-prior quirk
    # (PARITY #19) is exercised after a prior update
    theta = np.asarray(jsv.theta)
    costs = np.asarray(jc)
    jsv = jsv.replace(theta=jnp.asarray(theta))
    tsv = ts.init_state(_t(theta), tsv.prior)
    for _ in range(2):
        jsv, ja, jw = js.forward(jsv, jnp.asarray(costs))
        tsv, ta, tw = ts.forward(tsv, _t(costs))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **EXACT_TOL)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **EXACT_TOL)
        np.testing.assert_allclose(tsv.theta.numpy(), np.asarray(jsv.theta),
                                   **EXACT_TOL)
        np.testing.assert_allclose(tsv.prior.locs.numpy(),
                                   np.asarray(jsv.prior.locs), **EXACT_TOL)
        assert tsv.prior_updated and bool(jsv.prior_updated)


@pytest.mark.parametrize("strategy", ["repeat", "mean"])
def test_roll_and_weighted_prior(strategy):
    inp = _inputs(1)
    js, ts = _pair("rbf", False, weighted_prior=True, roll_strategy=strategy)
    jprior = JGMM.from_cov(inp["theta"], jnp.ones(M), 4.0 * jnp.eye(1))
    tprior = TGMM.from_cov(inp["theta"], torch.ones(M), 4.0 * torch.eye(1))
    jsv = js.roll(js.init_state(inp["theta"], jprior))
    tsv = ts.roll(ts.init_state(_t(inp["theta"]), tprior))
    np.testing.assert_allclose(tsv.theta.numpy(), np.asarray(jsv.theta),
                               **EXACT_TOL)
    w = np.array([0.1, 0.6, 0.0, 0.3], np.float32)
    jsv = js.update_prior(jsv, jnp.asarray(w))
    tsv = ts.update_prior(tsv, _t(w))
    np.testing.assert_allclose(tsv.prior.logits.numpy(),
                               np.asarray(jsv.prior.logits), **EXACT_TOL)
    costs = np.random.default_rng(2).uniform(100, 200, size=(N_S, M))
    np.testing.assert_allclose(
        ts.get_weights(tsv, _t(costs)).numpy(),
        np.asarray(js.get_weights(jsv, jnp.asarray(costs, jnp.float32))),
        **EXACT_TOL,
    )


def test_resample_roll_draws_from_the_prior():
    inp = _inputs(3)
    _, ts = _pair("rbf", False, roll_strategy="resample")
    prior = TGMM.from_cov(inp["theta"], torch.ones(M), 1e-6 * torch.eye(1))
    sv = ts.roll(ts.init_state(_t(inp["theta"]), prior),
                 generator=torch.Generator().manual_seed(0))
    rolled = np.roll(inp["theta"], -1, axis=-2)
    np.testing.assert_array_equal(sv.theta.numpy()[:, :-1], rolled[:, :-1])
    # the last step is a draw of some prior component's last step
    last = sv.theta.numpy()[:, -1, 0]
    assert all(np.isclose(v, inp["theta"][:, -1, 0], atol=0.01).any()
               for v in last)


def test_svmpc_rejects_other_optimizers():
    """An unknown optimizer name raises (SGD, Adam and optimizer objects
    are taken: test_svmpc_adam_matches_jax)."""
    js, ts = _pair("rbf", False)
    with pytest.raises(ValueError, match="optimizer must be one of"):
        TSVMPC(ts.likelihood, n_particles=M, optimizer="rmsprop")


def _adam_leaves(jstate):
    """(count, mu, nu) of JAX's optax.adam state."""
    s = jstate[0]
    return int(s.count), np.asarray(s.mu), np.asarray(s.nu)


@pytest.mark.parametrize("kernel", ["rbf", "message_passing"])
def test_svmpc_adam_matches_jax(kernel):
    """`SVMPC(optimizer="adam", lr=0.1)` against JAX's
    `SVMPC(optimizer=optax.adam(0.1))`, fresh injected noise each step:
    three svgd_steps, then forward (which rolls theta and leaves Adam's
    moments unrolled, as JAX's does) and one more step on the unrolled
    moments. theta at STEP_TOL, the moments at STEP_TOL scaled by Adam's
    (1 - b) weights, the count exactly. Adam's first step is lr *
    g / (|g| + eps): no element of the first gradient is below 1e-5 in
    magnitude here (counted, so a change of inputs that makes one shows)."""
    rng = np.random.default_rng(11)
    inp = _inputs(4)
    js, ts = _pair(kernel, False, adam_lr=0.1)
    jprior = JGMM.from_cov(inp["theta"], jnp.ones(M), 4.0 * jnp.eye(1))
    tprior = TGMM.from_cov(inp["theta"], torch.ones(M), 4.0 * torch.eye(1))
    jsv = js.init_state(inp["theta"], jprior)
    tsv = ts.init_state(_t(inp["theta"]), tprior)
    assert tsv.opt_state.count == 0
    jd = js.controller.init_state(inp["theta"])
    td = ts.controller.init_state(_t(inp["theta"]))
    bw = np.asarray(j_silverman(jsv.theta))

    def step(jsv, tsv, jd, td):
        noise = rng.normal(size=(N_S, M, H, 1)).astype(np.float32)
        jsv, jd, jc = js.svgd_step(jsv, jd, jnp.asarray(inp["state"]),
                                   _JStub(inp["draws"], inp["log_p"]),
                                   jax.random.key(0), jnp.asarray(bw),
                                   noise=jnp.asarray(noise))
        tsv, td, tc = ts.svgd_step(tsv, td, _t(inp["state"]),
                                   _TStub(inp["draws"], inp["log_p"]), None,
                                   torch.tensor(bw), noise=_t(noise))
        np.testing.assert_allclose(tsv.theta.numpy(), np.asarray(jsv.theta),
                                   **STEP_TOL)
        count, mu, nu = _adam_leaves(jsv.opt_state)
        assert tsv.opt_state.count == count
        np.testing.assert_allclose(tsv.opt_state.mu.numpy(), mu, **STEP_TOL)
        np.testing.assert_allclose(tsv.opt_state.nu.numpy(), nu,
                                   rtol=2 * STEP_TOL["rtol"],
                                   atol=STEP_TOL["atol"] ** 2)
        return jsv, tsv, jd, td, jc, tc

    for i in range(3):
        jsv, tsv, jd, td, jc, tc = step(jsv, tsv, jd, td)
        if i == 0:
            # the first moment is (1 - b1) * g: |phi| = |mu| / 0.1
            small = int((np.abs(tsv.opt_state.mu.numpy()) / 0.1
                         < 1e-5).sum())
            assert small == 0, f"{small} elements with |phi| < 1e-5"
    jsv, ja, _ = js.forward(jsv, jc)
    tsv, ta, _ = ts.forward(tsv, tc)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **STEP_TOL)
    np.testing.assert_allclose(tsv.theta.numpy(), np.asarray(jsv.theta),
                               **STEP_TOL)
    # the moments stay where they were; theta moved one step along H
    assert tsv.opt_state.count == 3
    jsv, tsv, jd, td, _, _ = step(jsv, tsv, jd, td)
    assert tsv.opt_state.count == 4


def test_svmpc_state_rate_with_adam():
    """`SVMPCState.lr` replaces the rate of Adam too: a state at rate 0.02
    steps as an SVMPC built at 0.02."""
    inp = _inputs(5)
    _, ts = _pair("rbf", False, adam_lr=0.5)
    _, ts_at = _pair("rbf", False, adam_lr=0.02)
    prior = TGMM.from_cov(inp["theta"], torch.ones(M), 4.0 * torch.eye(1))
    outs = []
    for s, lr in ((ts, 0.02), (ts_at, None)):
        sv = s.init_state(_t(inp["theta"]), prior)
        sv = type(sv)(theta=sv.theta, prior=sv.prior, lr=lr,
                      opt_state=sv.opt_state)
        sv, _, _ = s.svgd_step(sv, s.controller.init_state(
            _t(inp["theta"])), _t(inp["state"]),
            _TStub(inp["draws"], inp["log_p"]), None,
            t_silverman(sv.theta), noise=_t(inp["noise"]))
        outs.append(sv.theta)
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], _t(inp["theta"]))
