"""K8 and `FusedParticleSVMPC`: the port's whole particle solve (whose
wrapper runs the kernel's plain version on CPU tensors) against the JAX
`fused_particle_solve(interpret=True)`; the port's `FusedParticleSVMPC`
optimize + forward with a weighted prior against the JAX class on the
same arrays and noise; the fused class against the port's plain `SVMPC`
on one generator seed, weighted and not; and a `fused_solve: true`
closed loop against the plain path (mirrors tests/test_pallas_solve.py,
particle part).

Tolerances: the kernel function against the JAX kernel: costs and weights
at rtol 1e-5 (atol 1e-4 scaled by the w_obs = 1e6 obstacle terms of the
costs), particles and plans at the closed loop's per-step rtol 1e-3,
atol 5e-4; class against class at tests/test_pallas_solve.py:148,186's
rtol 2e-3, atol 2e-3, the closed loop at rtol 5e-3, atol 5e-3."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.experiments import build_particle_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.ops.pallas_particle_rollout import (
    particle_kernel_statics as j_statics,
)
from dust_tpu.ops.pallas_solve import fused_particle_solve as j_solve
from dust_tpu_torch.convert import (
    disco_state_from_numpy,
    particle_stack_from_numpy,
)
from dust_tpu_torch.experiments import (
    PARTICLE_DEMO_CONFIG,
    build_particle_stack,
)
from dust_tpu_torch.inference import FusedSVMPCState
from dust_tpu_torch.ops import solve as tsolve
from dust_tpu_torch.ops.particle_rollout import particle_kernel_statics
from dust_tpu_torch.simulation import particle_episode_fn

YAML = "demo/particle_config.yaml"
H, M, NP, NA = 40, 6, 4, 64
STEP_TOL = dict(rtol=1e-3, atol=5e-4)
CLASS_TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _explicit_lane_sum(t, lanes):
    """The sum over t's last axis as a group of `lanes` kernel lanes takes
    it, written out in float32: lane l adds j = l, l + lanes, ... in turn
    from 0, then neighbouring lanes meet pairwise, for 8 lanes
    ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)). Keeps the axis."""
    a = t.numpy().astype(np.float32)
    acc = [np.zeros(a.shape[:-1], np.float32) for _ in range(lanes)]
    for j in range(a.shape[-1]):
        acc[j % lanes] = (acc[j % lanes] + a[..., j]).astype(np.float32)
    while len(acc) > 1:
        acc = [(x + y).astype(np.float32)
               for x, y in zip(acc[0::2], acc[1::2])]
    return torch.from_numpy(acc[0])[..., None]


def test_demo_config_equals_yaml():
    assert PARTICLE_DEMO_CONFIG == load_config(YAML)


def _solve_inputs(seed, start):
    rng = np.random.default_rng(seed)
    theta = (3.0 * rng.normal(size=(M, H, 2))).astype(np.float32)
    logits = rng.normal(size=M)
    return dict(
        state0=np.array([*start, 0.3, -0.2], np.float32),
        theta=theta,
        locs=(theta + 0.5 * rng.normal(size=theta.shape)).astype(np.float32),
        log_mix=(logits - np.log(np.exp(logits).sum())).astype(np.float32),
        a_mat=rng.normal(size=(M, H, 2)).astype(np.float32),
        a_seq=(0.1 * rng.normal(size=(H, 2))).astype(np.float32),
        actions=(theta[None] + 5.0 * rng.normal(size=(NA, M, H, 2))
                 ).astype(np.float32),
        masses=rng.uniform(1.7, 2.4, NP).astype(np.float32),
    )


_SCALARS = dict(bw=1.3, lr=100.0, alpha=1.0, temp=1.0, ctrl_sigma=5.0,
                prior_sigma=5.0)
_OUTS = ("theta_opt", "theta_fwd", "a_mat", "a_mix", "a_seq_sel", "weights",
         "costs")


@pytest.mark.parametrize("start", [(-9.0, -9.0), (2.0, 2.0)])
@pytest.mark.parametrize("exp_util", [True, False])
def test_solve_plain_matches_jax_at_demo_shapes(start, exp_util):
    from dust_tpu.models import Particle as JParticle
    from dust_tpu_torch.models import Particle as TParticle

    env = PARTICLE_DEMO_CONFIG["env_params"]
    jm = JParticle(uncertain_params=["mass"], mass=2.0, **env)
    tm = TParticle(uncertain_params=["mass"], mass=2.0, device="cpu", **env)
    inp = _solve_inputs(0, start)
    statics = dict(hz=H, m=M, n_params=NP, n_act=NA, dt=0.015, max_acc=10.0,
                   max_speed=5.0, exp_util=exp_util)
    j = j_solve(*(jnp.asarray(v) for v in inp.values()), *_SCALARS.values(),
                interpret=True, **statics, **j_statics(jm))
    before = tsolve.fused_particle_solve.launches
    t = tsolve.fused_particle_solve(*(_t(v) for v in inp.values()),
                                    *_SCALARS.values(), **statics,
                                    **particle_kernel_statics(tm))
    assert tsolve.fused_particle_solve.launches == before  # plain on CPU
    for name, a, b in zip(_OUTS, j, t):
        a = np.asarray(a)
        if name == "costs":
            tol = dict(rtol=1e-5, atol=1e-4 * max(1.0, np.abs(a).max() / 1e6))
        elif name == "weights":
            tol = dict(rtol=1e-5, atol=1e-4)
        else:
            tol = STEP_TOL
        np.testing.assert_allclose(b.numpy(), a, err_msg=name, **tol)
    theta_opt, theta_fwd, a_sel = t[0].numpy(), t[1].numpy(), t[4].numpy()
    assert any(np.array_equal(a_sel, row) for row in theta_opt)
    np.testing.assert_array_equal(theta_fwd[:, :-1], theta_opt[:, 1:])
    np.testing.assert_array_equal(theta_fwd[:, -1], theta_opt[:, -1])
    if start == (2.0, 2.0):
        assert t[6].min() > 1e7       # every rollout starts crashed


def test_plain_delta_sums_in_the_kernels_lane_order(monkeypatch):
    """K8's delta and likelihood gradient sum over the 64 action samples in
    the kernel's order, 8 lanes per entry (csrc/particle_solve.cu:
    kSumLanes): with `lane_sum` replaced by that order written out, the
    solve gives the same bits (two sums of [m, hz * 2, n_act] terms, both
    through that order)."""
    from dust_tpu_torch.models import Particle as TParticle
    from dust_tpu_torch.ops import particle_mpf

    tm = TParticle(uncertain_params=["mass"], mass=2.0, device="cpu",
                   **PARTICLE_DEMO_CONFIG["env_params"])
    inp = _solve_inputs(3, (-9.0, -9.0))
    statics = dict(hz=H, m=M, n_params=NP, n_act=NA, dt=0.015, max_acc=10.0,
                   max_speed=5.0, **particle_kernel_statics(tm))

    def run():
        return tsolve.fused_particle_solve(*(_t(v) for v in inp.values()),
                                           *_SCALARS.values(), **statics)

    want = run()
    assert tsolve.SUM_LANES == 8
    calls = []

    def explicit(t, lanes):
        calls.append((tuple(t.shape), lanes))
        return _explicit_lane_sum(t, lanes)

    monkeypatch.setattr(particle_mpf, "lane_sum", explicit)
    for name, g, w in zip(_OUTS, run(), want):
        assert torch.equal(g, w), name
    assert calls == [((M, 2 * H, NA), 8)] * 2


@pytest.mark.parametrize("dims,match", [
    (dict(n_act=129), "n_actions"), (dict(m=9), "n_particles"),
    (dict(hz=65), "horizon"),
])
def test_solve_shape_guards_raise_as_in_jax(dims, match):
    shape = dict(hz=8, m=3, n_params=2, n_act=4)
    shape.update(dims)
    hz, m, n_act = shape["hz"], shape["m"], shape["n_act"]
    z = lambda *s: np.zeros(s, np.float32)
    args = (z(4), z(m, hz, 2), z(m, hz, 2), z(m), z(m, hz, 2), z(hz, 2),
            z(n_act, m, hz, 2), np.ones(shape["n_params"], np.float32))
    kw = dict(dt=0.015, max_acc=10.0, max_speed=5.0, weights=(1.0,) * 11,
              target=(0.0,) * 4, rects=None, grid=None, crash=False)
    with pytest.raises(ValueError, match=match):
        j_solve(*(jnp.asarray(a) for a in args), *_SCALARS.values(),
                interpret=True, **shape, **kw)
    with pytest.raises(ValueError, match=match):
        tsolve.fused_particle_solve(*(_t(a) for a in args),
                                    *_SCALARS.values(), **shape, **kw)


def _reduced(fused_solve, **over):
    cfg = load_config(YAML)
    cfg["exp_params"].update(horizon=10, action_samples=9, params_samples=3,
                             n_particles=3, fused_solve=fused_solve, **over)
    return cfg


class _JDraws:
    """Fixed mass draws (log-space) for the JAX class."""

    def __init__(self, draws):
        self.draws = draws

    def sample(self, key, shape):
        return jnp.asarray(self.draws)

    def log_prob(self, x):
        return jnp.zeros(x.shape[0])


class _TDraws(_JDraws):
    def sample(self, generator, shape):
        return _t(self.draws)

    def log_prob(self, x):
        return torch.zeros(x.shape[0])


def test_weighted_prior_refresh_matches_jax_on_the_same_arrays():
    """`FusedParticleSVMPC.optimize` + `forward` with `weighted_prior:
    true`, two rounds, the second starting from the first's weighted
    prior: the port against `dust_tpu`'s class, from a JAX-built stack
    carried across with `convert`, with JAX's action noise and fixed mass
    draws injected. theta, the prior locs and the prior logits agree."""
    cfg = _reduced(True)
    assert cfg["exp_params"]["weighted_prior"]
    js = j_build(cfg, jax.random.key(0))
    arrays = {
        "init_policies": js.init_policies,
        "policies_prior.locs": js.policies_prior.locs,
        "policies_prior.scale_tril": js.policies_prior.scale_tril,
        "policies_prior.logits": js.policies_prior.logits,
        "mpf_init": js.mpf_init, "init_state": js.init_state,
    }
    ts = particle_stack_from_numpy({k: np.asarray(v)
                                    for k, v in arrays.items()}, cfg,
                                   device="cpu")
    jd = js.controller.init_state()
    td = disco_state_from_numpy(jd.a_seq, jd.a_mat, jd.a_mix, device="cpu")
    jsv = js.svmpc.init_state(js.init_policies, js.policies_prior)
    tsv = ts.svmpc.init_state(ts.init_policies, ts.policies_prior)
    assert isinstance(tsv, FusedSVMPCState)
    state = js.init_state.reshape(1, -1)
    exp = cfg["exp_params"]
    rng = np.random.default_rng(4)
    for i in range(2):
        key = jax.random.fold_in(jax.random.key(21), i)
        # the noise JAX's optimize draws from `key` (its split discipline)
        (k,) = jax.random.split(key, 1)
        k_act, _ = jax.random.split(k)
        noise = jax.random.normal(k_act, (exp["action_samples"], 3, 10, 2))
        draws = np.log(rng.uniform(1.7, 2.4, (exp["params_samples"], 1)))
        jsv, jd, jc = js.svmpc.optimize(jsv, jd, state, _JDraws(draws), key)
        tsv, td, tc = ts.svmpc.optimize(tsv, td, _t(state), _TDraws(draws),
                                        None, noise=_t(noise))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                                   atol=1e-3)
        for a, b in ((tsv.theta, jsv.theta), (td.a_mat, jd.a_mat)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CLASS_TOL)
        jsv, ja, jw = js.svmpc.forward(jsv, jc)
        tsv, ta, tw = ts.svmpc.forward(tsv, tc)
        for name, a, b in (
                ("weights", tw, jw), ("a_seq", ta, ja),
                ("theta", tsv.theta, jsv.theta),
                ("prior locs", tsv.prior.locs, jsv.prior.locs),
                ("prior logits", torch.log_softmax(tsv.prior.logits, 0),
                 jax.nn.log_softmax(jsv.prior.logits))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"round {i} {name}",
                                       **CLASS_TOL)
        # the refreshed prior is weighted: not the uniform mixture
        assert float(torch.log_softmax(tsv.prior.logits, 0).std()) > 1e-3


def _stack(fused_solve, **over):
    cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
    cfg["exp_params"].update(horizon=10, action_samples=9, params_samples=3,
                             n_particles=3, fused_solve=fused_solve, **over)
    return build_particle_stack(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


@pytest.mark.parametrize("weighted", [True, False])
def test_fused_svmpc_matches_plain_on_one_seed(weighted):
    plain = _stack(False, weighted_prior=weighted)
    fused = _stack(True, weighted_prior=weighted)
    d_p = plain.controller.init_state()
    d_f = fused.controller.init_state()
    sv_p = plain.svmpc.init_state(plain.init_policies, plain.policies_prior)
    sv_f = fused.svmpc.init_state(fused.init_policies, fused.policies_prior)
    state = plain.init_state.reshape(1, -1)
    pd = plain.dynamics_prior
    for i in range(2):
        sv_p, d_p, c_p = plain.svmpc.optimize(
            sv_p, d_p, state, pd, torch.Generator().manual_seed(2 * i))
        sv_f, d_f, c_f = fused.svmpc.optimize(
            sv_f, d_f, state, pd, torch.Generator().manual_seed(2 * i))
        for a, b in ((c_f, c_p), (sv_f.theta, sv_p.theta),
                     (d_f.a_mat, d_p.a_mat)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **CLASS_TOL)
        sv_p, a_p, w_p = plain.svmpc.forward(sv_p, c_p)
        sv_f, a_f, w_f = fused.svmpc.forward(sv_f, c_f)
        for a, b in ((w_f, w_p), (a_f, a_p),
                     (torch.log_softmax(sv_f.prior.logits, 0),
                      torch.log_softmax(sv_p.prior.logits, 0))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **CLASS_TOL)


def test_fused_svmpc_guards():
    with pytest.raises(ValueError, match="deterministic"):
        cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
        cfg["env_params"]["deterministic"] = False
        cfg["exp_params"]["fused_solve"] = True
        build_particle_stack(cfg, torch.Generator(), device="cpu")
    stack = _stack(True)
    sv = stack.svmpc.init_state(stack.init_policies, stack.policies_prior)
    with pytest.raises(ValueError, match="n_steps=1"):
        stack.svmpc.optimize(sv, stack.controller.init_state(), None, None,
                             torch.Generator(), n_steps=2)


def test_fused_solve_closed_loop_tracks_plain_path():
    """A short episode (crash masks, mass change at steps // 4) with
    warm_up 1: the fused_solve stack against the plain stack on one
    generator seed."""
    outs = {}
    for fused in (False, True):
        stack = _stack(fused)
        episode = particle_episode_fn(
            stack.model, stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
            dyn_dist=stack.dynamics_prior, load=stack.load, steps=6,
            warm_up=1, mpf_bw=stack.mpf_bw, mpf_steps=stack.mpf_steps)
        sv = stack.svmpc.init_state(stack.init_policies,
                                    stack.policies_prior)
        ms = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
        outs[fused] = episode(torch.Generator().manual_seed(9),
                              stack.init_state, stack.controller.init_state(),
                              sv, ms, stack.model.params_dict["mass"])
    state_f, done_f, crashed_f, cum_f, logs_f = outs[True]
    state_p, done_p, crashed_p, cum_p, logs_p = outs[False]
    np.testing.assert_allclose(state_f.numpy(), state_p.numpy(), rtol=5e-3,
                               atol=5e-3)
    assert crashed_f == crashed_p
    np.testing.assert_allclose(float(cum_f), float(cum_p), rtol=5e-3,
                               atol=5e-3)
    assert float(logs_f[1].abs().max()) > 0.1     # the controller acted
