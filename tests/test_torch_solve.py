"""K3 and `FusedPendulumSVMPC`: the port's whole-solve function (whose
wrapper runs the kernel's plain version on CPU tensors) against the JAX
`fused_pendulum_solve(interpret=True)`, its shape guards, the fused SVMPC
class against the port's plain `SVMPC` on one generator seed, and a
`fused_solve: true` closed loop against the plain path (mirrors
tests/test_pallas_solve.py).

Tolerances: costs and weights at K1's (rtol 1e-5, atol 1e-4); particles,
plans and the selected sequence at the closed loop's per-step tolerance
(rtol 1e-3, atol 5e-4): the likelihood gradient and the DISCO update
weight samples by softmax(-costs), which turns one-ulp cost differences
(torch's vs XLA's sin/cos) into ~1e-4 relative weight differences. The
fused-vs-plain comparisons also absorb K3's rotation-tracked rollout
against the plain path's sin(th + pi) (ROADMAP Queue 3)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.ops.pallas_solve import fused_pendulum_solve as j_solve
from dust_tpu_torch.experiments import (
    PENDULUM_DEMO_CONFIG,
    build_pendulum_stack,
)
from dust_tpu_torch.inference import FusedSVMPCState, SVMPCState
from dust_tpu_torch.ops import solve as tsolve
from dust_tpu_torch.simulation import PendulumSimulation

H, M, NP, NA = 30, 3, 8, 128
K1_TOL = dict(rtol=1e-5, atol=1e-4)
STEP_TOL = dict(rtol=1e-3, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _solve_inputs(seed=0, hz=H, m=M, n_params=NP, n_act=NA,
                  state0=(3.0, 0.0)):
    rng = np.random.default_rng(seed)
    theta = (0.5 * rng.normal(size=(m, hz))).astype(np.float32)
    return dict(
        state0=np.array(state0, np.float32),
        theta=theta,
        locs=(theta + 0.1 * rng.normal(size=(m, hz))).astype(np.float32),
        log_mix=np.log(np.full(m, 1.0 / m, np.float32)),
        a_mat=rng.normal(size=(m, hz)).astype(np.float32),
        a_seq=(0.1 * rng.normal(size=(hz,))).astype(np.float32),
        actions=(theta[None] + 2.0 * rng.normal(size=(n_act, m, hz))
                 ).astype(np.float32),
        lengths=rng.uniform(0.6, 1.3, n_params).astype(np.float32),
        masses=rng.uniform(0.6, 1.3, n_params).astype(np.float32),
    )


_SCALARS = dict(bw=0.3, lr=2.0, alpha=1.0, temp=1.0, ctrl_sigma=2.0,
                prior_sigma=2.0)


@pytest.mark.parametrize("exp_util", [True, False])
def test_solve_plain_matches_jax_at_demo_shapes(exp_util):
    inp = _solve_inputs()
    statics = dict(hz=H, m=M, n_params=NP, n_act=NA, dt=0.05, g=9.8,
                   exp_util=exp_util)
    j = j_solve(*(jnp.asarray(v) for v in inp.values()),
                *_SCALARS.values(), interpret=True, **statics)
    before = tsolve.fused_pendulum_solve.launches
    t = tsolve.fused_pendulum_solve(
        *(_t(v) for v in inp.values()), torch.tensor(_SCALARS["bw"]),
        *list(_SCALARS.values())[1:], **statics)
    assert tsolve.fused_pendulum_solve.launches == before  # plain on CPU
    names = ("theta_opt", "theta_fwd", "a_mat", "a_mix", "a_seq_sel",
             "weights", "costs")
    for name, a, b in zip(names, j, t):
        tol = K1_TOL if name in ("costs", "weights") else STEP_TOL
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **tol)
    # the selected sequence is a row of the optimized particles, and the
    # roll repeats the last step
    theta_opt, theta_fwd = t[0].numpy(), t[1].numpy()
    assert any(np.array_equal(t[4].numpy(), row) for row in theta_opt)
    np.testing.assert_array_equal(theta_fwd[:, :-1], theta_opt[:, 1:])
    np.testing.assert_array_equal(theta_fwd[:, -1], theta_opt[:, -1])


_OUTS = ("theta_opt", "theta_fwd", "a_mat", "a_mix", "a_seq_sel", "weights",
         "costs")


@pytest.mark.parametrize("hz,m,n_params,n_act,state0", [
    (30, 1, 8, 128, (3.0, 0.0)),     # the kernel's cluster of one block
    (30, 8, 8, 128, (3.0, 0.0)),     # of eight, the portable maximum
    (11, 2, 3, 7, (0.2, 7.9)),       # odd shapes near the speed clamp
])
def test_solve_plain_matches_jax_at_cluster_extremes(hz, m, n_params, n_act,
                                                     state0):
    """K3's plain version, its delta in the kernel's 8-lane order, against
    JAX's K3 in interpret mode at the extremes of the kernel's cluster
    (one block per policy particle) and at an odd shape."""
    inp = _solve_inputs(seed=m, hz=hz, m=m, n_params=n_params, n_act=n_act,
                        state0=state0)
    statics = dict(hz=hz, m=m, n_params=n_params, n_act=n_act, dt=0.05,
                   g=9.8, exp_util=True)
    j = j_solve(*(jnp.asarray(v) for v in inp.values()),
                *_SCALARS.values(), interpret=True, **statics)
    t = tsolve.fused_pendulum_solve(*(_t(v) for v in inp.values()),
                                    *_SCALARS.values(), **statics)
    for name, a, b in zip(_OUTS, j, t):
        tol = K1_TOL if name in ("costs", "weights") else STEP_TOL
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **tol)


def _explicit_lane_sum(t, lanes):
    """The sum over t's last axis as a group of `lanes` kernel lanes takes
    it, written out in float32: lane l adds i = l, l + lanes, ... in turn
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


def test_plain_delta_sums_in_the_kernels_lane_order(monkeypatch):
    """K3's delta and likelihood gradient sum over the 128 action samples
    in the kernel's order, 8 lanes per entry, and the new particles'
    prior logits over the horizon, 8 lanes per particle pair
    (csrc/pendulum_solve.cu:kSumLanes): with `lane_sum` replaced by that
    order written out, the solve gives the same bits (two sums of
    [m, hz, n_act] terms and m of [1, m, hz], all through that order);
    with a plain sum the plan update and the particles do not."""
    from dust_tpu_torch.ops import particle_mpf

    inp = _solve_inputs(seed=4)
    statics = dict(hz=H, m=M, n_params=NP, n_act=NA)
    # soft weights (high temperature, low alpha), so that many samples
    # carry weight in both sums
    scalars = dict(_SCALARS, alpha=1e-3, temp=1e3)

    def run():
        return tsolve.fused_pendulum_solve(*(_t(v) for v in inp.values()),
                                           *scalars.values(), **statics)

    want = run()
    assert tsolve.SUM_LANES == 8
    calls = []

    def explicit(t, lanes):
        calls.append((tuple(t.shape), lanes))
        return _explicit_lane_sum(t, lanes)

    monkeypatch.setattr(particle_mpf, "lane_sum", explicit)
    for name, g, w in zip(_OUTS, run(), want):
        assert torch.equal(g, w), name
    assert calls == [((M, H, NA), 8)] * 2 + [((1, M, H), 8)] * M
    monkeypatch.setattr(particle_mpf, "lane_sum",
                        lambda t, lanes: t.sum(dim=-1, keepdim=True))
    got = run()
    assert not torch.equal(got[2], want[2])      # the plan update
    assert not torch.equal(got[0], want[0])      # the particles


@pytest.mark.parametrize("dim_s", [2, 4])
def test_solve_scal_passes_the_scalars_raw(dim_s):
    """K3 and K8 share one scalar packer, which gathers the values as they
    come (the kernels and their plain versions take the reciprocals), so
    a call launches no arithmetic of its own."""
    state0 = torch.arange(1.0, 5.0)
    vals = (0.3, torch.tensor(2.0), 1e-3, torch.tensor([1e3]), 2.0, 0.5)
    scal = tsolve._solve_scal(state0, *vals, torch.device("cpu"),
                              dim_s=dim_s)
    want = [*state0[:dim_s].tolist(), 0.3, 2.0, 1e-3, 1e3, 2.0, 0.5]
    assert scal.dtype == torch.float32 and scal.shape == (dim_s + 6,)
    np.testing.assert_array_equal(scal.numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dims,match", [
    (dict(n_act=129), "n_actions"),
    (dict(m=9), "n_particles"),
    (dict(hz=129), "horizon"),
])
def test_solve_shape_guards_raise_as_in_jax(dims, match):
    shape = dict(hz=8, m=3, n_params=2, n_act=4)
    shape.update(dims)
    inp = _solve_inputs(hz=shape["hz"], m=shape["m"],
                        n_params=shape["n_params"], n_act=shape["n_act"])
    with pytest.raises(ValueError, match=match):
        j_solve(*(jnp.asarray(v) for v in inp.values()),
                *_SCALARS.values(), interpret=True, **shape)
    with pytest.raises(ValueError, match=match):
        tsolve.fused_pendulum_solve(*(_t(v) for v in inp.values()),
                                    *_SCALARS.values(), **shape)


def _config(fused_solve, **over):
    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    cfg["exp_params"].update(horizon=12, action_samples=9, params_samples=3,
                             n_particles=3, fused_solve=fused_solve, **over)
    return cfg


def _stack(fused_solve, case="dust", **over):
    return build_pendulum_stack(_config(fused_solve, **over),
                                torch.Generator().manual_seed(0), case=case,
                                device="cpu")


def _inputs(stack):
    dstate = stack.controller.init_state(stack.init_policies)
    svstate = stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior)
    return dstate, svstate, stack.init_state.reshape(1, -1)


@pytest.mark.parametrize("case", ["dust", "svmpc"])
@pytest.mark.parametrize("likelihood", ["ExponentiatedUtility",
                                        "ExpectedCost"])
def test_fused_svmpc_matches_plain_on_one_seed(case, likelihood):
    plain = _stack(False, case, likelihood=likelihood)
    fused = _stack(True, case, likelihood=likelihood)
    d_p, sv_p, state = _inputs(plain)
    d_f, sv_f, _ = _inputs(fused)
    assert isinstance(sv_f, FusedSVMPCState)
    pd = plain.dynamics_prior if case == "dust" else None

    sv_p, d_p, c_p = plain.svmpc.optimize(
        sv_p, d_p, state, pd, torch.Generator().manual_seed(11))
    sv_f, d_f, c_f = fused.svmpc.optimize(
        sv_f, d_f, state, pd, torch.Generator().manual_seed(11))
    np.testing.assert_allclose(c_f.numpy(), c_p.numpy(), **K1_TOL)
    for got, want in ((sv_f.theta, sv_p.theta), (d_f.a_mat, d_p.a_mat),
                      (d_f.a_mix, d_p.a_mix)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **STEP_TOL)

    sv_p2, a_p, w_p = plain.svmpc.forward(sv_p, c_p)
    sv_f2, a_f, w_f = fused.svmpc.forward(sv_f, c_f)
    np.testing.assert_allclose(w_f.numpy(), w_p.numpy(), **K1_TOL)
    for got, want in ((a_f, a_p), (sv_f2.theta, sv_p2.theta),
                      (sv_f2.prior.locs, sv_p2.prior.locs)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **STEP_TOL)


def test_fused_svmpc_guards():
    with pytest.raises(ValueError, match="unweighted"):
        _stack(True, weighted_prior=True)
    stack = _stack(True)
    with pytest.raises(ValueError, match="n_steps=1"):
        stack.svmpc.optimize(*_inputs(stack)[1::-1], None, None,
                             torch.Generator(), n_steps=2)


def test_fused_solve_closed_loop_tracks_plain_path():
    """8 steps with warm_up 2: the fused_solve stack against the plain
    stack, the plain side starting every step from the fused side's
    state, both drawing from generators with one seed."""
    stacks = {f: _stack(f) for f in (False, True)}
    harness = {
        f: PendulumSimulation(
            controller=s.controller, svmpc=s.svmpc, mpf=s.mpf, model=s.model,
            steps=8, warm_up=2, mpf_bw=s.mpf_bw, mpf_steps=s.mpf_steps,
            device="cpu")
        for f, s in stacks.items()
    }
    steps = {f: harness[f].step_fn(s.dynamics_prior)
             for f, s in stacks.items()}
    s = stacks[True]
    obs = s.init_state.reshape(1, -1)
    f_carry = (torch.Generator().manual_seed(5), obs,
               s.controller.init_state(s.init_policies),
               s.svmpc.init_state(s.init_policies, s.policies_prior),
               s.mpf.init_state(s.mpf_init, obs[0], 1))
    p_gen = torch.Generator().manual_seed(5)
    true = {"length": torch.tensor(1.0), "mass": torch.tensor(1.0)}
    for t in range(8):
        sv = f_carry[3]
        p_carry = (p_gen, f_carry[1], f_carry[2],
                   SVMPCState(theta=sv.theta, prior=sv.prior,
                              prior_updated=t > 0),
                   f_carry[4])
        f_carry, f_log = steps[True](f_carry, t, true)
        p_carry, p_log = steps[False](p_carry, t, true)
        for i, name in enumerate(("obs", "action", "cost", "theta")):
            np.testing.assert_allclose(f_log[i].numpy(), p_log[i].numpy(),
                                       err_msg=f"step {t} {name}",
                                       **STEP_TOL)
        np.testing.assert_allclose(f_log[5].numpy(), p_log[5].numpy(),
                                   err_msg=f"step {t} MPF particles",
                                   **STEP_TOL)
        if t < 2:  # warm-up: no forward, zero action
            assert float(f_log[1].abs().max()) == 0.0
