"""The slice as a whole: the pendulum DuSt dual loop of `dust_tpu_torch`
against `dust_tpu`'s, from a JAX-built stack carried across with
`dust_tpu_torch.convert`.

Each MPC step is composed as `PendulumSimulation.step_fn` composes it
(SVMPC optimize with the Silverman bandwidth, forward, simulator step,
MPF optimize), on the kernel-path classes: the fused rollout-cost hook
(K1) and `FusedPendulumMPF` (K2), which run their plain versions on CPU
tensors and the JAX kernels in interpret mode. Action noise and
parameter draws are injected; the port is re-synced to the JAX state
after every step, so each step compares one step's arithmetic.

Tolerances (tests/test_equivalence_dual.py's): steps 0-4 at rtol 1e-3,
atol 5e-4; the whole run at rtol 5e-3, atol 1e-2."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.experiments import build_pendulum_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.inference.mpf import FusedPendulumMPF as JFusedMPF
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.ops.bandwidth import silvermans_rule as j_silverman
from dust_tpu.simulation import PendulumSimulation as JSim
from dust_tpu_torch.convert import (
    disco_state_from_numpy,
    mpf_state_from_numpy,
    stack_arrays_from_numpy,
    svmpc_state_from_numpy,
)
from dust_tpu_torch.experiments import PENDULUM_DEMO_CONFIG
from dust_tpu_torch.inference import FusedPendulumMPF as TFusedMPF
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.ops.bandwidth import silvermans_rule as t_silverman
from dust_tpu_torch.simulation import COLUMNS, PendulumSimulation, to_dataframe

YAML = "demo/pendulum_config.yaml"
STEPS = 10
TRUE = {"length": 1.05, "mass": 0.9}
EARLY_TOL = dict(rtol=1e-3, atol=5e-4)
RUN_TOL = dict(rtol=5e-3, atol=1e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


class _JStub:
    """Cycles through pre-drawn parameter draws, one per forward call."""

    def __init__(self, draws, log_ps):
        self.draws, self.log_ps, self.i = draws, log_ps, 0

    def sample(self, key, shape):
        return jnp.asarray(self.draws[self.i])

    def log_prob(self, x):
        lp = jnp.asarray(self.log_ps[self.i])
        self.i += 1
        return lp


class _TStub(_JStub):
    def sample(self, generator, shape):
        return _t(self.draws[self.i])

    def log_prob(self, x):
        lp = _t(self.log_ps[self.i])
        self.i += 1
        return lp


def _reduced_config(**over):
    cfg = load_config(YAML)
    reduced = dict(horizon=10, action_samples=16, params_samples=4,
                   n_particles=3, mpf_n_particles=12, mpf_steps=5)
    cfg["exp_params"].update({**reduced, **over})
    return cfg


def _stack_arrays(js):
    arrays = {
        "init_policies": js.init_policies,
        "policies_prior.locs": js.policies_prior.locs,
        "policies_prior.scale_tril": js.policies_prior.scale_tril,
        "policies_prior.logits": js.policies_prior.logits,
        "mpf_init": js.mpf_init,
        "dynamics_prior.low": js.dynamics_prior.low,
        "dynamics_prior.high": js.dynamics_prior.high,
        "init_state": js.init_state,
    }
    return {k: np.asarray(v) for k, v in arrays.items()}


def _sync(jsv, jd, jms):
    """The port's solver states from the JAX ones, through numpy."""
    tsv = svmpc_state_from_numpy(
        jsv.theta, jsv.prior.locs, jsv.prior.scale_tril, jsv.prior.logits,
        jsv.prior_updated, device="cpu")
    td = disco_state_from_numpy(jd.a_seq, jd.a_mat, jd.a_mix, device="cpu")
    tms = mpf_state_from_numpy(
        jms.x, jms.prior.locs, jms.prior.scale_tril, jms.prior.logits,
        jms.lik.loc, jms.lik.past_obs, jms.lik.past_action, jms.prior_bw,
        device="cpu")
    return tsv, td, tms


def test_demo_config_equals_yaml():
    assert PENDULUM_DEMO_CONFIG == load_config(YAML)


def test_dual_loop_kernel_path_matches_jax_step_by_step():
    cfg = _reduced_config(fused_rollout=True)
    exp = cfg["exp_params"]
    js = j_build(cfg, jax.random.key(0), case="dust")
    ts = stack_arrays_from_numpy(_stack_arrays(js), cfg, device="cpu")
    assert js.controller.fused_state_costs is not None
    assert ts.controller.fused_state_costs is not None
    jmpf = JFusedMPF(likelihood=js.mpf.likelihood, interpret=True,
                     lr=exp["mpf_learning_rate"], n_steps=exp["mpf_steps"],
                     bw_scale=exp["mpf_bandwidth_scaling"])
    # the port's kernel-path swap, as chip_smoke.py makes it
    tmpf = TFusedMPF.from_mpf(ts.mpf)
    assert (tmpf.lr, tmpf.n_steps) == (exp["mpf_learning_rate"],
                                       exp["mpf_steps"])
    j_sim = JPendulum(g=10.0)
    t_sim = TPendulum(g=10.0)
    j_true = {k: jnp.float32(v) for k, v in TRUE.items()}
    t_true = {k: torch.tensor(v) for k, v in TRUE.items()}

    rng = np.random.default_rng(0)
    noise = rng.normal(size=(STEPS, 16, 3, 10, 1)).astype(np.float32)
    draws = rng.uniform(0.6, 1.3, size=(STEPS, 4, 2)).astype(np.float32)
    log_ps = rng.normal(size=(STEPS, 4)).astype(np.float32)
    j_stub, t_stub = _JStub(draws, log_ps), _TStub(draws, log_ps)

    init_obs = np.asarray(js.init_state).reshape(1, -1)
    j_obs = jnp.asarray(init_obs)
    jsv = js.svmpc.init_state(js.init_policies, js.policies_prior)
    jd = js.controller.init_state(js.init_policies)
    jms = jmpf.init_state(js.mpf_init, j_obs[0], 1)
    # the port's own initial states from the carried-across stack
    tsv = ts.svmpc.init_state(ts.init_policies, ts.policies_prior)
    td = ts.controller.init_state(ts.init_policies)
    tms = tmpf.init_state(ts.mpf_init, _t(init_obs[0]), 1)
    np.testing.assert_allclose(tms.prior.scale_tril.numpy(),
                               np.asarray(jms.prior.scale_tril), rtol=1e-5)

    key = jax.random.key(1)  # unused: all noise injected
    rows = {"action": [], "obs": [], "mpf_x": [], "theta": [], "costs": []}
    for t in range(STEPS):
        t_obs = _t(j_obs)
        jbw, tbw = j_silverman(jsv.theta), t_silverman(tsv.theta)
        jsv, jd, jc = js.svmpc.svgd_step(jsv, jd, j_obs, j_stub, key, jbw,
                                         noise=jnp.asarray(noise[t]))
        tsv, td, tc = ts.svmpc.svgd_step(tsv, td, t_obs, t_stub, None, tbw,
                                         noise=_t(noise[t]))
        jsv, ja, _ = js.svmpc.forward(jsv, jc)
        tsv, ta, _ = ts.svmpc.forward(tsv, tc)
        j_obs = j_sim.step(j_obs, ja[0][None], j_true)
        t_obs = t_sim.step(t_obs, ta[0][None], t_true)
        jms, _, _ = jmpf.optimize(jms, ja[0], j_obs[0], bw=None)
        tms, _, _ = tmpf.optimize(tms, ta[0], t_obs[0], bw=None)
        for name, a, b in (("action", ta[0], ja[0]), ("obs", t_obs, j_obs),
                           ("mpf_x", tms.x, jms.x),
                           ("theta", tsv.theta, jsv.theta),
                           ("costs", tc, jc)):
            rows[name].append((a.numpy(), np.asarray(b)))
        # re-sync: the next step starts from the JAX state on both sides
        tsv, td, tms = _sync(jsv, jd, jms)

    for name, pairs in rows.items():
        ours = np.stack([p[0] for p in pairs])
        theirs = np.stack([p[1] for p in pairs])
        tol = (dict(rtol=2e-5, atol=2e-4) if name == "costs" else EARLY_TOL)
        np.testing.assert_allclose(ours[:5], theirs[:5], err_msg=name, **tol)
        np.testing.assert_allclose(ours, theirs, err_msg=name, **RUN_TOL)
    actions = np.stack([p[1] for p in rows["action"]])
    assert np.abs(actions).max() > 0.5      # the controller acted


def test_simulation_run_columns_match_jax_dataframe():
    """A 5-step episode at reduced width through both harnesses: the
    port's columns, as a DataFrame, have the JAX DataFrame's schema."""
    cfg = _reduced_config(mpf_steps=2)
    js = j_build(cfg, jax.random.key(0), case="dust")
    ts = stack_arrays_from_numpy(_stack_arrays(js), cfg, device="cpu")
    kw = dict(steps=5, warm_up=1, mpf_bw=None, mpf_steps=2)
    params = [copy.deepcopy(TRUE)]
    j_df = JSim(controller=js.controller, svmpc=js.svmpc, mpf=js.mpf,
                model=js.model, **kw).run(
        jax.random.key(1), params, init_state=js.init_state,
        init_policies=js.init_policies, policies_prior=js.policies_prior,
        dyn_dist=js.dynamics_prior, mpf_init=js.mpf_init)
    cols = PendulumSimulation(controller=ts.controller, svmpc=ts.svmpc,
                              mpf=ts.mpf, model=ts.model, device="cpu",
                              **kw).run(
        torch.Generator().manual_seed(1), params, init_state=ts.init_state,
        init_policies=ts.init_policies, policies_prior=ts.policies_prior,
        dyn_dist=ts.dynamics_prior, mpf_init=ts.mpf_init)
    t_df = to_dataframe(cols)

    assert list(t_df.columns) == list(j_df.columns) == list(COLUMNS)
    assert list(t_df.index) == list(j_df.index)
    for name in ("Timestep", "Iteration", "ExpParams"):
        assert t_df[name].tolist() == j_df[name].tolist()
    for name in ("Cost", "Position", "Speed", "Actions", "DynBandwidths"):
        assert t_df[name].dtype.kind == j_df[name].dtype.kind == "f"
        assert np.isfinite(t_df[name].to_numpy()).all()
    assert np.asarray(t_df["DynParticles"].iloc[0]).shape == \
        np.asarray(j_df["DynParticles"].iloc[0]).shape == (12, 2)
    assert len(t_df["PolParticles"].iloc[0]) == \
        len(j_df["PolParticles"].iloc[0]) == 3
    # the warm-up step emits a zero action and NaN weights in both
    assert t_df["Actions"].iloc[0] == j_df["Actions"].iloc[0] == 0.0
    assert np.isnan(t_df["Weights"].iloc[0]).all()
    assert np.isnan(j_df["Weights"].iloc[0]).all()
    # the first step has no action yet: both simulators start identically
    np.testing.assert_allclose(t_df["Position"].iloc[0],
                               j_df["Position"].iloc[0], rtol=1e-6)


def test_entry_points_default_to_the_card_and_raise_without_one():
    from dust_tpu_torch.experiments import build_pendulum_stack

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pendulum_stack(cfg, torch.Generator())
    cpu = build_pendulum_stack(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PendulumSimulation(controller=cpu.controller, svmpc=cpu.svmpc,
                           mpf=cpu.mpf, model=cpu.model)
