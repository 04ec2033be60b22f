"""K6: the port's particle rollout-cost function (whose wrapper runs the
kernel's plain version on CPU tensors) against the JAX
`fused_particle_rollout_costs(interpret=True)` and against a rollout loop
over the port's `Particle.step` and cost functions, the MultiDisco hook
against the plain rollout path, and the model checks (mirrors
tests/test_pallas_particle_rollout.py).

Tolerances are that file's: rtol 2e-5 with atol 2e-3 (obstacle maps,
where a cost holds w_obs = 1e6 terms) or 2e-4 (no map); the kernel
function against the JAX kernel at K1's rtol 1e-5, atol 1e-4 (the same
arithmetic in the same order)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.models import Particle as JParticle
from dust_tpu.ops.pallas_particle_rollout import (
    fused_particle_rollout_costs as j_costs,
)
from dust_tpu.ops.pallas_particle_rollout import (
    particle_kernel_statics as j_statics,
)
from dust_tpu_torch.experiments import (
    PARTICLE_DEMO_CONFIG,
    build_particle_stack,
)
from dust_tpu_torch.models import Particle as TParticle
from dust_tpu_torch.ops import particle_rollout as tpr

ENV = PARTICLE_DEMO_CONFIG["env_params"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _models(**over):
    env = dict(copy.deepcopy(ENV), **over)
    return (JParticle(uncertain_params=["mass"], mass=2.0, **env),
            TParticle(uncertain_params=["mass"], mass=2.0, device="cpu",
                      **env))


def _kw(model, statics):
    return dict(dt=float(model.dt), max_acc=model.max_acc,
                max_speed=model.max_speed, **statics)


def _loop_reference(model, s0, actions, masses):
    """Every (param, trajectory) pair stepped with model.step and the
    built-in cost functions, as MultiDisco.rollout + compute_cost do."""
    n_params = masses.shape[0]
    n_act, n_pol, hz, _ = actions.shape
    params = {"mass": masses.reshape(n_params, 1, 1, 1)}
    states = s0.expand(n_params, n_act, n_pol, 4)
    cost = torch.zeros((n_params, n_act, n_pol))
    for t in range(hz):
        cost = cost + model.default_inst_cost(states, actions[:, :, t, :])
        states = model.step(states, actions[:, :, t, :], params)
    return cost + model.default_term_cost(states)


def test_statics_equal_jax():
    jm, tm = _models()
    assert tpr.particle_kernel_statics(tm) == j_statics(jm)
    st = tpr.particle_kernel_statics(tm)
    model = tpr.model_tensor(st, tm.dt, tm.max_acc, tm.max_speed, "cpu")
    n_words = -(-220 * 220 // 32)
    assert model.shape == (tpr.MODEL_HEADER + n_words,)
    assert model[tpr.MODEL_HEADER - 3:tpr.MODEL_HEADER].tolist() == [
        1.0, 1.0, float(n_words)]
    # the words carry the raster's bits, cell xi * 220 + yi
    bits = np.unpackbits(model[tpr.MODEL_HEADER:].numpy().view(np.uint8),
                         bitorder="little")[:220 * 220]
    np.testing.assert_array_equal(bits.reshape(220, 220),
                                  tm.obst_map.map > 0)
    free = tpr.model_tensor(tpr.particle_kernel_statics(
        _models(with_obstacle=False, can_crash=False)[1]), 0.015, 10.0, 5.0,
        "cpu")
    assert free.shape == (tpr.MODEL_HEADER,)
    assert free[tpr.MODEL_HEADER - 3:].tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("start,shape", [
    ((-9.0, -9.0), (4, 64, 6, 40)),      # the demo width, a free start
    ((2.0, 2.0), (3, 7, 3, 11)),         # inside an obstacle
    ((10.95, 0.3), (3, 7, 3, 11)),       # inside the east wall
])
def test_kernel_function_matches_jax_kernel(start, shape):
    jm, tm = _models()
    n_params, n_act, n_pol, hz = shape
    rng = np.random.default_rng(1)
    actions = (12.0 * rng.normal(size=(n_act, n_pol, hz, 2))).astype(
        np.float32)
    masses = rng.uniform(1.5, 3.0, n_params).astype(np.float32)
    s0 = np.array([*start, 0.8, 1.2], np.float32)
    want = np.asarray(j_costs(jnp.asarray(s0), jnp.asarray(actions),
                              jnp.asarray(masses), interpret=True,
                              **_kw(jm, j_statics(jm))))
    before = tpr.fused_particle_rollout_costs.launches
    got = tpr.fused_particle_rollout_costs(
        _t(s0), _t(actions), _t(masses), **_kw(tm, tpr.particle_kernel_statics(tm)))
    assert tpr.fused_particle_rollout_costs.launches == before  # plain: CPU
    assert got.shape == (n_params, n_act, n_pol)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    if start != (-9.0, -9.0):
        # crash-frozen from step 0: every step charges w_obs
        assert got.min() >= (hz + 1) * 1e6


@pytest.mark.parametrize("shape", [(4, 64, 6, 40), (3, 7, 5, 11),
                                   (9, 5, 3, 7)])
def test_kernel_reads_the_actions_in_their_native_layout(shape):
    """K6 takes the actions as the caller holds them, [n_act, n_pol, H, 2]:
    `kernel_operands` hands the kernel the caller's own storage (no copy,
    so a call launches K6 and nothing else), and the kernel's indexing of
    that storage (csrc/particle_rollout.cu: block b takes trajectories
    r = 32 b + lane, step t's action at r * 2 H + 2 t and + 1, a warp per
    mass draw p, the cost written at p * n_traj + r), written out here over
    the flat storage, gives `particle_rollout_costs_plain`'s costs bit for
    bit."""
    _, tm = _models()
    n_params, n_act, n_pol, hz = shape
    g = torch.Generator().manual_seed(7)
    actions = 12.0 * torch.randn((n_act, n_pol, hz, 2), generator=g)
    masses = 1.5 + 1.5 * torch.rand((n_params,), generator=g)
    s0 = torch.tensor([-9.0, -9.0, 0.8, 1.2])
    kw = _kw(tm, tpr.particle_kernel_statics(tm))
    ks0, acts, kmasses = tpr.kernel_operands(s0, actions, masses)
    assert (ks0.data_ptr(), acts.data_ptr(), kmasses.data_ptr()) == (
        s0.data_ptr(), actions.data_ptr(), masses.data_ptr())
    flat = acts.reshape(-1)
    n_traj, ev = n_act * n_pol, 2 * hz
    st = tpr._statics(hz, kw["dt"], kw["max_acc"], kw["max_speed"],
                      kw["weights"], kw["target"], kw["rects"], kw["grid"],
                      kw["crash"])
    im = (1.0 / kmasses).reshape(n_params, 1)
    got = torch.empty(n_params * n_traj)
    for b in range(-(-n_traj // tpr.TRAJ_PER_BLOCK)):
        r = b * tpr.TRAJ_PER_BLOCK + torch.arange(tpr.TRAJ_PER_BLOCK)
        r = r[r < n_traj]
        rows = flat[r[:, None] * ev + torch.arange(ev)]      # [nb, 2 H]
        cost = tpr.rollout_costs(
            tuple(ks0[i] for i in range(4)),
            lambda t: (rows[:, 2 * t], rows[:, 2 * t + 1]), im,
            (n_params, r.numel()), st)
        got[(torch.arange(n_params)[:, None] * n_traj + r).reshape(-1)] = (
            cost.reshape(-1))
    want = tpr.particle_rollout_costs_plain(s0, actions, masses, **kw)
    assert torch.equal(got.reshape(n_params, n_act, n_pol), want)


@pytest.mark.parametrize("start", [(-9.0, -9.0), (0.0, 0.0), (2.0, 2.0)])
def test_kernel_function_matches_step_loop(start):
    """Cost parity over trajectories that cross obstacle cells; (0, 0)
    lies between the four central obstacles, (2, 2) inside one."""
    _, tm = _models()
    g = torch.Generator().manual_seed(1)
    actions = 12.0 * torch.randn((7, 3, 11, 2), generator=g)
    masses = 1.5 + 1.5 * torch.rand((4,), generator=g)
    s0 = torch.tensor([*start, 0.8, 1.2])
    got = tpr.fused_particle_rollout_costs(
        s0, actions, masses, **_kw(tm, tpr.particle_kernel_statics(tm)))
    want = _loop_reference(tm, s0, actions, masses)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-3)


def test_kernel_function_no_obstacles():
    jm, tm = _models(with_obstacle=False, can_crash=False)
    st = tpr.particle_kernel_statics(tm)
    assert st["rects"] is None and not st["crash"]
    g = torch.Generator().manual_seed(2)
    actions = 12.0 * torch.randn((5, 2, 9, 2), generator=g)
    masses = 1.5 + 1.5 * torch.rand((3,), generator=g)
    s0 = torch.tensor([-9.0, -9.0, 0.0, 0.0])
    got = tpr.fused_particle_rollout_costs(s0, actions, masses,
                                           **_kw(tm, st))
    np.testing.assert_allclose(
        got.numpy(), _loop_reference(tm, s0, actions, masses).numpy(),
        rtol=2e-5, atol=2e-4)
    want = np.asarray(j_costs(jnp.asarray(s0.numpy()),
                              jnp.asarray(actions.numpy()),
                              jnp.asarray(masses.numpy()), interpret=True,
                              **_kw(jm, j_statics(jm))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _stack(fused):
    cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
    cfg["exp_params"].update(
        horizon=10, action_samples=8, params_samples=3, n_particles=3,
        mpf_n_particles=8, mpf_steps=2, fused_rollout=fused,
    )
    return build_particle_stack(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


def test_forward_and_solve_through_the_hook_match_plain():
    plain, fused = _stack(False), _stack(True)
    assert plain.controller.fused_state_costs is None
    assert fused.controller.fused_state_costs is not None
    dstate = plain.controller.init_state()
    state = plain.init_state[None]
    out_p = plain.controller.forward(dstate, state, plain.model,
                                     plain.dynamics_prior,
                                     torch.Generator().manual_seed(7))
    out_f = fused.controller.forward(dstate, state, fused.model,
                                     fused.dynamics_prior,
                                     torch.Generator().manual_seed(7))
    np.testing.assert_allclose(out_f[1].numpy(), out_p[1].numpy(),
                               rtol=2e-5, atol=2e-3)
    for a, b in ((out_f[0].a_mat, out_p[0].a_mat),
                 (out_f[0].a_mix, out_p[0].a_mix)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-4)
    assert out_f[2] is None and out_p[2] is not None

    svstate = plain.svmpc.init_state(plain.init_policies,
                                     plain.policies_prior)
    sv_p, d_p, c_p = plain.svmpc.optimize(svstate, dstate, state,
                                          plain.dynamics_prior,
                                          torch.Generator().manual_seed(3))
    sv_f, d_f, c_f = fused.svmpc.optimize(svstate, dstate, state,
                                          fused.dynamics_prior,
                                          torch.Generator().manual_seed(3))
    np.testing.assert_allclose(c_f.numpy(), c_p.numpy(), rtol=2e-5,
                               atol=2e-3)
    for a, b in ((sv_f.theta, sv_p.theta), (d_f.a_mat, d_p.a_mat)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=2e-4)


def test_hook_rejects_unsupported_configs():
    _, stochastic = _models(deterministic=False)
    with pytest.raises(ValueError, match="deterministic"):
        tpr.make_fused_particle_state_costs(stochastic)
    _, velocity = _models(control_type="velocity")
    with pytest.raises(ValueError, match="acceleration"):
        tpr.make_fused_particle_state_costs(velocity)
    _, tm = _models()
    hook = tpr.make_fused_particle_state_costs(tm)
    s0 = torch.tensor([-9.0, -9.0, 0.0, 0.0])
    with pytest.raises(ValueError, match="mass"):
        hook(s0, torch.zeros((4, 2, 6, 2)),
             {"mass": torch.ones(2), "extra_load": torch.ones(2)})
    # nominal mass without params: one draw
    assert hook(s0, torch.zeros((4, 2, 6, 2)), None).shape == (4, 2)


def test_occupancy_probe_plain_matches_the_raster():
    _, tm = _models()
    st = tpr.particle_kernel_statics(tm)
    cells = torch.arange(220, dtype=torch.float32)
    xi, yi = torch.meshgrid(cells, cells, indexing="ij")
    # cell centers in world coordinates
    pts = (torch.stack([xi, yi], -1).reshape(-1, 2) + 0.5 - 110.0) * 0.1
    occ = tpr.particle_occupancy_probe(pts, rects=st["rects"],
                                       grid=st["grid"])
    np.testing.assert_array_equal(occ.reshape(220, 220).numpy(),
                                  tm.obst_map.map)
    jax.clear_caches()
