"""MultiDisco's UTF sigma-point mode and the `disco_utf` case of
`dust_tpu_torch` against `dust_tpu`'s.

The sigma points are deterministic: both sides take the same dynamics
distribution and the same injected action noise (`eps_noise`), so the
forward pass compares one update's arithmetic. Tolerances are
tests/test_disco.py's (costs rtol 2e-4, states atol 1e-4, omega atol
1e-5, a_mat atol 1e-4); the closed loop, re-synced after every step, is
held at tests/test_equivalence_dual.py's per-step rtol 1e-3, atol 5e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.controllers import MultiDisco as JDisco
from dust_tpu.distributions import MVN as JMVN
from dust_tpu.distributions import Uniform as JUniform
from dust_tpu.experiments import build_pendulum_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.experiments import pendulum_cost_fns as j_cost_fns
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.utils.utf import MerweScaledUTF as JUTF
from dust_tpu_torch.controllers import MultiDisco as TDisco
from dust_tpu_torch.convert import (
    disco_state_from_numpy,
    stack_arrays_from_numpy,
)
from dust_tpu_torch.distributions import MVN as TMVN
from dust_tpu_torch.distributions import Uniform as TUniform
from dust_tpu_torch.experiments import build_pendulum_stack as t_build
from dust_tpu_torch.experiments import pendulum_cost_fns as t_cost_fns
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.simulation import PendulumSimulation as TSim
from dust_tpu_torch.utils import MerweScaledUTF as TUTF

YAML = "demo/pendulum_config.yaml"
FORWARD_TOL = dict(costs=dict(rtol=2e-4), states=dict(atol=1e-4),
                   omega=dict(atol=1e-5), a_mat=dict(atol=1e-4))
STEP_TOL = dict(rtol=1e-3, atol=5e-4)
STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _dists(kind):
    if kind == "uniform":
        low, high = np.array([0.6, 0.6]), np.array([1.3, 1.3])
        return (JUniform(jnp.asarray(low, jnp.float32),
                         jnp.asarray(high, jnp.float32), event_ndims=1),
                TUniform(_t(low), _t(high), event_ndims=1))
    loc = np.array([1.05, 0.9], np.float32)
    cov = np.array([[0.02, 0.006], [0.006, 0.03]], np.float32)
    return (JMVN.from_cov(jnp.asarray(loc), jnp.asarray(cov)),
            TMVN.from_cov(_t(loc), _t(cov)))


def _pair(correct_sqrt=False, n_pol=2, hz=12, n_act=16):
    kw = dict(hz_len=hz, n_policies=n_pol, action_samples=n_act,
              temperature=0.7)
    jm = JPendulum(uncertain_params=("length", "mass"))
    tm = TPendulum(uncertain_params=("length", "mass"))
    ji, jt = j_cost_fns()
    ti, tt = t_cost_fns()
    jc = JDisco(jm.observation_space, jm.action_space,
                a_cov=4.0 * jnp.eye(1), inst_cost_fn=ji, term_cost_fn=jt,
                params_sampling=JUTF(2, alpha=0.5,
                                     correct_sqrt=correct_sqrt), **kw)
    tc = TDisco(tm.observation_space, tm.action_space,
                a_cov=4.0 * torch.eye(1), inst_cost_fn=ti, term_cost_fn=tt,
                params_sampling=TUTF(2, alpha=0.5,
                                     correct_sqrt=correct_sqrt),
                device="cpu", **kw)
    return jm, tm, jc, tc


@pytest.mark.parametrize("ext", [False, True], ids=["eps_noise",
                                                    "ext_actions"])
@pytest.mark.parametrize("correct_sqrt", [False, True])
@pytest.mark.parametrize("dist", ["uniform", "mvn"])
def test_utf_forward_matches_jax(dist, correct_sqrt, ext):
    rng = np.random.default_rng(3)
    jm, tm, jc, tc = _pair(correct_sqrt)
    jdist, tdist = _dists(dist)
    init = rng.normal(size=(2, 12, 1)).astype(np.float32)
    eps = (2.0 * rng.normal(size=(16, 2, 12, 1))).astype(np.float32)
    state = np.array([[2.9, -0.4]], np.float32)
    jd, td = jc.init_state(init), tc.init_state(init)
    if ext:
        acts = eps + init
        j_out = jc.forward(jd, jnp.asarray(state), jm, jdist,
                           ext_actions=jnp.asarray(acts))
        t_out = tc.forward(td, _t(state), tm, tdist, ext_actions=_t(acts))
    else:
        j_out = jc.forward(jd, jnp.asarray(state), jm, jdist,
                           eps_noise=jnp.asarray(eps))
        t_out = tc.forward(td, _t(state), tm, tdist, eps_noise=_t(eps))
    # five sigma points, each a [16, 2] block of 12-step rollouts
    assert t_out[2].shape == np.asarray(j_out[2]).shape == (5, 16, 2, 13, 2)
    for name, i in (("costs", 1), ("states", 2), ("omega", 4)):
        np.testing.assert_allclose(t_out[i].numpy(), np.asarray(j_out[i]),
                                   err_msg=name, **FORWARD_TOL[name])
    np.testing.assert_allclose(t_out[0].a_mat.numpy(),
                               np.asarray(j_out[0].a_mat),
                               **FORWARD_TOL["a_mat"])
    np.testing.assert_allclose(t_out[0].a_mix.numpy(),
                               np.asarray(j_out[0].a_mix), atol=1e-5)
    # the sigma points' log-probs averaged with the location weights
    np.testing.assert_allclose(float(t_out[5]), float(j_out[5]), rtol=1e-5)


def test_utf_costs_are_the_weighted_sum_over_sigma_points():
    """The costs weight each sigma point's rollout cost by the location
    weights (not their mean); the sigma points are the parameters of
    each block of rollouts."""
    rng = np.random.default_rng(4)
    _, tm, _, tc = _pair()
    _, tdist = _dists("mvn")
    td = tc.init_state()
    eps = _t(2.0 * rng.normal(size=(16, 2, 12, 1)))
    state = _t([[0.3, 1.0]])
    _, costs, states, actions, _, _ = tc.forward(td, state, tm, tdist,
                                                 eps_noise=eps)
    mean, cov = tdist.mean, tdist.covariance
    sp = tc._tf.compute_sigma_points(mean, cov)
    per_point = []
    for p in range(5):
        params = {"length": sp[0, p], "mass": sp[1, p]}
        s = tc.rollout(state, tm, actions, params)
        np.testing.assert_allclose(s.numpy(), states[p].numpy(), rtol=1e-6,
                                   atol=1e-6)
        per_point.append(tc.compute_cost(td, s[None], actions))
    weighted = torch.tensordot(tc._tf.loc_weights, torch.stack(per_point),
                               dims=1)
    np.testing.assert_allclose(costs.numpy(), weighted.numpy(), rtol=1e-5,
                               atol=1e-3)


def _utf_config(**over):
    cfg = load_config(YAML)
    cfg["exp_params"].update(dict(horizon=10, action_samples=16, **over))
    return cfg


def test_disco_utf_case_builds_as_jax():
    cfg = _utf_config(fused_rollout=True)
    js = j_build(cfg, jax.random.key(0), case="disco_utf")
    ts = t_build(cfg, torch.Generator().manual_seed(0), case="disco_utf",
                 device="cpu")
    for s in (js, ts):
        assert s.svmpc is None and s.mpf is None and s.mpf_init is None
        assert s.controller.n_pol == 1 and s.controller.n_params == 1
        # the sigma-point weighting needs each point's cost: no fused hook
        assert s.controller.fused_state_costs is None
        assert s.controller._params_mode == "utf"
        assert s.model.uncertain_params == ("length", "mass")
    assert (ts.controller._tf.n, ts.controller._tf.alpha) == (2, 0.5)
    assert not ts.controller._tf.correct_sqrt
    assert ts.init_policies.shape == tuple(js.init_policies.shape)
    cfg["utf"]["correct_sqrt"] = True
    assert t_build(cfg, torch.Generator(), case="disco_utf",
                   device="cpu").controller._tf.correct_sqrt
    with pytest.raises(ValueError, match="unknown case"):
        t_build(cfg, torch.Generator(), case="utf", device="cpu")


def test_disco_utf_closed_loop_matches_jax_step_by_step():
    """The disco_utf case's MPC step (forward over the sigma points of
    the static dynamics prior, average strategy, simulator g = 10) from a
    JAX-built stack carried across, re-synced to JAX's controller state
    after every step."""
    cfg = _utf_config()
    js = j_build(cfg, jax.random.key(0), case="disco_utf")
    arrays = {k: np.asarray(v) for k, v in (
        ("init_policies", js.init_policies),
        ("policies_prior.locs", js.policies_prior.locs),
        ("policies_prior.scale_tril", js.policies_prior.scale_tril),
        ("policies_prior.logits", js.policies_prior.logits),
        ("dynamics_prior.low", js.dynamics_prior.low),
        ("dynamics_prior.high", js.dynamics_prior.high),
        ("init_state", js.init_state))}
    ts = stack_arrays_from_numpy(arrays, cfg, device="cpu", case="disco_utf")
    jc, tc = js.controller, ts.controller
    j_sim, t_sim = JPendulum(g=10.0), TPendulum(g=10.0)
    true = {"length": 1.05, "mass": 0.9}
    j_true = {k: jnp.float32(v) for k, v in true.items()}
    t_true = {k: torch.tensor(v) for k, v in true.items()}
    rng = np.random.default_rng(5)
    noise = (2.0 * rng.normal(size=(STEPS, 16, 1, 10, 1))).astype(np.float32)

    jd = jc.init_state(js.init_policies)
    j_obs = jnp.asarray(np.asarray(js.init_state).reshape(1, -1))
    rows = {"costs": [], "a_mat": [], "action": [], "obs": []}
    for t in range(STEPS):
        td = disco_state_from_numpy(jd.a_seq, jd.a_mat, jd.a_mix,
                                    device="cpu")
        t_obs = _t(j_obs)
        jd, jcost, *_ = jc.forward(jd, j_obs, js.model, js.dynamics_prior,
                                   eps_noise=jnp.asarray(noise[t]))
        td, tcost, *_ = tc.forward(td, t_obs, ts.model, ts.dynamics_prior,
                                   eps_noise=_t(noise[t]))
        rows["a_mat"].append((td.a_mat.numpy(), np.asarray(jd.a_mat)))
        jd, ja = jc.step(jd, strategy="average")
        td, ta = tc.step(td, strategy="average")
        j_obs = j_sim.step(j_obs, ja.reshape(1, -1), j_true)
        t_obs = t_sim.step(t_obs, ta.reshape(1, -1), t_true)
        for name, a, b in (("costs", tcost, jcost), ("action", ta, ja),
                           ("obs", t_obs, j_obs)):
            rows[name].append((a.numpy(), np.asarray(b)))
    for name, pairs in rows.items():
        ours = np.stack([p[0] for p in pairs])
        theirs = np.stack([p[1] for p in pairs])
        tol = FORWARD_TOL["costs"] if name == "costs" else STEP_TOL
        np.testing.assert_allclose(ours, theirs, err_msg=name, **tol)
    assert np.abs(np.stack([p[1] for p in rows["action"]])).max() > 0.5


def test_disco_utf_case_runs_through_the_harness():
    """PendulumSimulation's non-SVMPC branch runs the case unchanged:
    three steps, finite columns, no policy or MPF particles."""
    cfg = _utf_config()
    ts = t_build(cfg, torch.Generator().manual_seed(0), case="disco_utf",
                 device="cpu")
    harness = TSim(controller=ts.controller, svmpc=None, mpf=None,
                   model=ts.model, steps=3, warm_up=0, use_svmpc=False,
                   device="cpu")
    cols = harness.run(ts.generator, [{"length": 1.0, "mass": 1.0}],
                       ts.init_state, ts.init_policies,
                       dyn_dist=ts.dynamics_prior)
    for name in ("Cost", "Position", "Speed", "Actions", "Weights"):
        assert np.isfinite(cols[name]).all(), name
    assert cols["DynParticles"] is None
    assert cols["Cost"].shape == (3,)
    with pytest.raises(ValueError, match="log space"):
        TDisco(ts.model.observation_space, ts.model.action_space,
               hz_len=4, n_policies=1, action_samples=2,
               inst_cost_fn=t_cost_fns()[0], params_sampling=TUTF(2),
               params_log_space=True, device="cpu")
