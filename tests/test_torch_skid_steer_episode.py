"""K15 and its plain version (`ops/skid_steer_episode.py`): the plain
version against the benchmark's plain reference
(`perfbench/reference/skid_steer.py`) through the load on x_icr, the
hand-derived 3-D likelihood gradient against `torch.autograd` through
`models.SkidSteerNavigation.step`, the generic modules of
`build_particle_stack(task="skid_steer")` against the plain version's
first step on the same noise, the MPF loop over D values at D = 2 against
the two-value loop it replaced, and the sweep wrapper and adapter
(`ops/skid_steer_sweep_episode.py`,
`simulation.megakernel_skid_steer_sweep_fn`). The kernel itself runs only
on the card (chip_smoke.py, phase 43)."""

import copy
import json
import math

import pytest
import torch

from dust_tpu_torch.experiments import (
    SKID_STEER_DEMO_CONFIG,
    SKID_STEER_PARAMS,
    assemble_particle_stack,
    build_particle_stack,
    build_pendulum_stack,
    draw_particle_stack_arrays,
)
from dust_tpu_torch.inference.likelihoods import (
    GaussianLikelihood,
    LikelihoodState,
)
from dust_tpu_torch.models import SkidSteerNavigation
from dust_tpu_torch.ops import mpf as mpf_ops
from dust_tpu_torch.ops import skid_steer_episode as se
from dust_tpu_torch.ops import skid_steer_sweep_episode as sse
from dust_tpu_torch.ops import sweep_inputs
from dust_tpu_torch.ops.bandwidth import silvermans_rule
from dust_tpu_torch.ops.particle_mpf import lane_sum
from dust_tpu_torch.parallel import MegakernelGroupSweep
from dust_tpu_torch.simulation import megakernel_skid_steer_sweep_fn
from perfbench.harness import ROOT
from perfbench.reference import skid_steer as ref

SMALL = dict(horizon=6, action_samples=16, params_samples=2, n_particles=3,
             mpf_n_particles=8, mpf_steps=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**exp):
    cfg = copy.deepcopy(SKID_STEER_DEMO_CONFIG)
    cfg["exp_params"].update(SMALL, **exp)
    return cfg


def _arrays(cfg, seed):
    """Seeded random initial arrays: policies, their prior's locations, the
    MPF particles from the prior, the start."""
    return draw_particle_stack_arrays(
        cfg, torch.Generator().manual_seed(seed), device="cpu")


def _statics(stack, cfg, steps, load_step):
    exp = cfg["exp_params"]
    return se.episode_statics(
        steps=steps, hz=exp["horizon"], m=exp["n_particles"],
        n_params=exp["params_samples"], n_act=exp["action_samples"],
        m_mpf=exp["mpf_n_particles"], mpf_steps=exp["mpf_steps"],
        load_step=load_step, load_scale=stack.load,
        success_dist=stack.success_dist, mpf_fixed_bw=stack.mpf_bw,
        **se.skid_steer_kernel_statics(stack.model))


def _inputs(stack, cfg, ep_f, seeds, scenario, prior_bw):
    exp = cfg["exp_params"]
    B, m, hz = ep_f.shape[0], exp["n_particles"], exp["horizon"]
    per_ep = lambda v: v.reshape(1, m, 2 * hz).expand(B, m, 2 * hz)
    return dict(
        scal=se.skid_steer_scal(
            stack.init_state, exp["ctrl_sigma"], exp["learning_rate"],
            exp["alpha"], 1.0 / exp["alpha"], exp["prior_sigma"],
            exp["mpf_learning_rate"], exp["mpf_obs_std"], prior_bw, "cpu"),
        ep_f=ep_f, seeds=seeds, scenario=scenario,
        log_mix0=torch.log_softmax(stack.policies_prior.logits, dim=0),
        theta0=per_ep(stack.init_policies),
        locs0=per_ep(stack.policies_prior.locs),
        amat0=torch.zeros(B, m, 2 * hz),
        mpfx0=stack.mpf_init[None].expand(B, *stack.mpf_init.shape),
        eps=None, pdz=None, pdu=None)


# -- the plain version against the reference ----------------------------------


def test_demo_config_is_the_benchmarks_configuration():
    """`SKID_STEER_DEMO_CONFIG` is the benchmark's configuration file's
    content, its prior beside it; its DuSt widths are the particle demo's."""
    from dust_tpu_torch.experiments import PARTICLE_DEMO_CONFIG

    f = json.loads((ROOT / "perfbench" / "configs" / "skid_steer.json")
                   .read_text())
    assert SKID_STEER_DEMO_CONFIG == {**f["config"],
                                      "dynamics_prior": f["dynamics_prior"]}
    assert (f["task"], f["case"], f["reduced"]) == ("skid_steer", "dust", [])
    exp, pexp = (c["exp_params"] for c in (SKID_STEER_DEMO_CONFIG,
                                           PARTICLE_DEMO_CONFIG))
    for k in ("horizon", "n_particles", "action_samples", "params_samples",
              "mpf_n_particles", "mpf_steps", "mpf_learning_rate",
              "mpf_obs_std", "likelihood", "alpha"):
        assert exp[k] == pexp[k], k
    # the departures, each under `assumed`: the MPF bandwidth (fixed, and
    # the first) and the initial policies' scale
    assert exp["mpf_bandwidth"] == exp["mpf_init_bandwidth"] == 0.05
    assert exp["init_policy_scale"] == 0.05
    assert {"mpf_bandwidth", "init_policy_scale", "course", "dt", "cost",
            "load"} <= set(f["assumed"])


@pytest.mark.parametrize("noise", ["injected", "device_rng"])
def test_plain_version_equals_the_reference_through_the_load(noise):
    """2 groups x 2 scenarios x 1 chain, horizon 6, 16 samples, 2 draws, 3
    plans, 8 MPF particles x 3 Stein steps, K = 5 steps of 8-step episodes,
    so that the load on x_icr comes at step 2. With `injected` noise the
    plain version reads the reference's draws as tensors, its test seam.
    States, actions, costs, flags and bandwidths: equal to 1e-6 relative of
    their size, as the two share the step's order of operations (the CPU's
    sin and cos on both); the MPF particles to 1e-5: the reference takes
    the likelihood gradient by autograd, the plain version by hand, which
    differ by rounding."""
    cfg = _config()
    exp = cfg["exp_params"]
    arrays = _arrays(cfg, 7)
    stack = assemble_particle_stack(cfg, arrays, device="cpu")
    G, n_sc, K, steps = 2, 2, 5, 8
    seeds = torch.tensor([[11, 3], [12, 5]])
    x_icr = torch.tensor([[0.15, 0.25], [0.2, 0.18]])
    rad = torch.tensor([[0.06, 0.065], [0.0625, 0.057]])
    base = torch.tensor([[0.43, 0.5], [0.475, 0.52]])
    ep = ref.sweep_inputs(exp, arrays, seeds, x_icr, rad, base, 1,
                          torch.float32)
    rarrays = {"theta0": arrays["init_policies"],
               "locs0": arrays["policies_prior.locs"],
               "mpf_init": arrays["mpf_init"],
               "init_state": arrays["init_state"]}
    want = ref.sweep_reference(cfg, rarrays, ep, K, steps)

    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    inputs = _inputs(stack, cfg, ep["params"], ep["seeds"], ep["scenario"],
                     mstate.prior_bw)
    if noise == "injected":
        draws = [se.device_noise(ep["seeds"], ep["scenario"], t, 6, 3, 16, 2)
                 for t in range(K)]
        for i, k in enumerate(("eps", "pdz", "pdu")):
            inputs[k] = torch.stack([d[i] for d in draws], dim=1)
    st = _statics(stack, cfg, K, steps // 4)
    log, _, _, _, x = se.episode_plain(inputs, st)
    for i, f in enumerate(se.LOG_FIELDS):
        w = want[f]
        scale = w.abs() + w.abs().mean()
        assert ((log[..., i] - w).abs() <= 1e-6 * scale).all(), f
    # the load doubled x_icr from step 2: the simulator differs from an
    # unloaded step there (the robot turns, so the lateral shift moves it)
    s1 = torch.stack([want[f][:, 1] for f in se.LOG_FIELDS[:5]], -1)
    act = torch.stack([want["a_r"][:, 2], want["a_l"][:, 2]], -1)
    unloaded = ref.step(s1, act, *ep["params"].unbind(-1), ref.statics(cfg))
    s2 = torch.stack([want[f][:, 2] for f in se.LOG_FIELDS[:5]], -1)
    assert not torch.allclose(unloaded[:, :2], s2[:, :2])
    want_x = ref.mpf_chain(cfg, rarrays, want)
    assert torch.allclose(x, want_x, rtol=1e-5, atol=1e-5)


def test_plain_version_ends_an_episode_at_a_crash():
    """A start inside an obstacle (the planner steers clear of one it sees
    coming): the crash freeze holds the robot's pose, the episode ends at
    its first step as a crash and its state stays frozen from there. The
    reference's simulator, cost and goal test redo every logged step from
    the logged wheel speeds, and its MPF alone over the logged episode
    gives the plain version's particles, to 1e-6 relative (1e-5 for the MPF
    particles). (The plans themselves are not compared: inside an obstacle
    every rollout costs over 4e7, where the two orders of the control
    cost's rounding pick other samples.)"""
    cfg = _config()
    cfg["env_params"]["init_state"] = [1.0, 0.0, math.pi / 2, 0.0, 0.0]
    exp = cfg["exp_params"]
    arrays = _arrays(cfg, 3)
    stack = assemble_particle_stack(cfg, arrays, device="cpu")
    seeds = torch.tensor([[21, 4]])
    params = [torch.tensor([[0.2, 0.25]]), torch.tensor([[0.0625, 0.068]]),
              torch.tensor([[0.475, 0.45]])]
    ep = ref.sweep_inputs(exp, arrays, seeds, *params, 1, torch.float32)
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    inputs = _inputs(stack, cfg, ep["params"], ep["seeds"], ep["scenario"],
                     mstate.prior_bw)
    K = 6
    log, _, _, _, x = se.episode_plain(inputs, _statics(stack, cfg, K, 50))
    logs = {f: log[..., i] for i, f in enumerate(se.LOG_FIELDS)}
    assert (logs["crashed"] > 0.5).all() and (logs["done"] > 0.5).all()
    # the pose never moves; the speeds are the first step's commands, then
    # the whole state stays frozen
    assert (log[:, :, :3] == stack.init_state[:3]).all()
    assert (log[:, 1:, :5] == log[:, :1, :5]).all()

    states = log[:, :, :5]
    prev = torch.cat([stack.init_state.expand(2, 1, 5), states[:, :-1]], 1)
    moved = ref.simulate(prev, log[:, :, 5:7], ep["params"], cfg,
                         torch.arange(K), 200)
    want = torch.where(prev.new_tensor([0.0] + [1.0] * (K - 1))[None, :, None]
                       > 0.5, prev, moved)
    cost, ended = ref.state_cost(want, cfg)
    close = lambda a, b: ((a - b).abs()
                          <= 1e-6 * (b.abs() + b.abs().mean())).all()
    assert close(states, want) and close(logs["cost"], cost)
    assert ended.all() and (cost >= 1e6).all()
    rarrays = {"mpf_init": arrays["mpf_init"],
               "init_state": arrays["init_state"]}
    assert torch.allclose(x, ref.mpf_chain(cfg, rarrays, logs), rtol=1e-5,
                          atol=1e-5)


# -- the likelihood gradient --------------------------------------------------


def _transitions(dtype):
    """Starts at several headings (and one inside an obstacle, where the
    crash freeze zeroes the step), wheel speeds inside and past the clamp,
    and observed next states from the model's defaults plus noise."""
    g = torch.Generator().manual_seed(3)
    r = lambda n, s: s * torch.randn(n, generator=g, dtype=dtype)
    n = 6
    s0 = torch.stack([
        torch.tensor([-1.8, 0.2, 1.0, 0.4, -1.2, 0.4], dtype=dtype),
        torch.tensor([-1.8, -0.6, 0.1, 1.7, 0.6, 0.4], dtype=dtype),
        torch.tensor([0.785, 3.0, -2.2, 0.1, 5.5, 1.0], dtype=dtype),
        r(n, 0.1), r(n, 0.5)], dim=-1)
    action = torch.tensor([[0.5, 0.3], [-0.2, 0.4], [0.7, -0.6],
                           [0.1, 0.1], [-0.45, -0.5], [0.3, -0.1]],
                          dtype=dtype)
    model = SkidSteerNavigation(delta_t=0.2, device="cpu", **_nav_kwargs())
    s1 = model.step(s0, action) + r(n * 5, 0.05).reshape(n, 5)
    return s0, action, s1


def _nav_kwargs():
    cfg = SKID_STEER_DEMO_CONFIG
    env = {k: v for k, v in cfg["env_params"].items()
           if k not in ("dt", "success_dist")}
    return dict(uncertain_params=SKID_STEER_PARAMS, **cfg["model_params"],
                **env)


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-4)])
def test_lik_grad_equals_autograd_through_the_model(log_space, dtype, tol):
    """The hand-derived gradient of the MPF's Gaussian observation
    log-likelihood (`lik_grad`, K15's SkidLik) with respect to (x_icr,
    wheel_radius, axial_distance) against torch.autograd through
    `SkidSteerNavigation.step` and `GaussianLikelihood.log_prob`, at random
    particles, one transition starting inside an obstacle (its crash
    factor zeroes the step). In float64 the two agree to 1e-10 relative
    (the algebra); in float32 to 1e-4 of the gradient's largest size (the
    rounding of the quotient's derivative and of the pose's sums)."""
    s0, action, s1 = _transitions(dtype)
    model = SkidSteerNavigation(delta_t=0.2, device="cpu", **_nav_kwargs())
    assert float(model._occupancy(s0[2])) == 1.0   # (1.0, 0.1): an obstacle
    assert float(model._occupancy(s0).sum()) == 1.0
    g = torch.Generator().manual_seed(4)
    lo = torch.tensor([0.05, 0.05, 0.38], dtype=dtype)
    hi = torch.tensor([0.6, 0.075, 0.57], dtype=dtype)
    x = lo + (hi - lo) * torch.rand(6, 20, 3, generator=g, dtype=dtype)
    if log_space:
        x = torch.log(x)
    # the step's time as the model takes it: dt times the map's float32
    # occupancy factor
    occ = model._occupancy(s0)
    scale = (0.2 * (1.0 - occ)).to(dtype)
    sigma = torch.full((6,), 0.1, dtype=dtype)
    lik = se.lik_grad(s0, action[:, 0], action[:, 1], s1, scale, sigma,
                      -0.5, 0.5, log_space)
    got = torch.cat(lik(x[..., 0:1], x[..., 1:2], x[..., 2:3]), dim=-1)

    gauss = GaussianLikelihood(0.1, model, log_space=log_space)
    want = []
    for b in range(6):
        state = LikelihoodState(loc=s1[b], past_obs=s0[b],
                                past_action=action[b])
        xb = x[b].clone().requires_grad_(True)
        pred = gauss.sample(state, xb)
        (grad,) = torch.autograd.grad(gauss.log_prob(state, pred).sum(), xb)
        want.append(grad)
    want = torch.stack(want)
    assert torch.isfinite(got).all()
    scale_g = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got - want).abs() <= tol * scale_g).all()
    # the x_icr component vanishes where the robot does not turn or is
    # frozen, and only there
    turning = (action[:, 0].clamp(-0.5, 0.5) != action[:, 1].clamp(-0.5, 0.5))
    moving = turning & (occ == 0)
    assert (want[~moving][..., 0] == 0).all()
    assert (want[moving][..., 0].abs().amax(dim=-1) > 0).all()


# -- the MPF loop over D values -----------------------------------------------


def _two_value_loop(x, prior_locs, bw, pbw, lr, lik, *, lanes, n_steps):
    """`ops/mpf.py:stein_loop_plain` as it was written for two values a
    particle, before it took D."""
    m = x.shape[-2]
    inv_pbw2 = 1.0 / (pbw * pbw)
    inv_bw2 = 1.0 / (bw * bw)
    c0t = prior_locs[..., :, 0].unsqueeze(-2)
    c1t = prior_locs[..., :, 1].unsqueeze(-2)
    x0 = x[..., :, 0:1]
    x1 = x[..., :, 1:2]
    for _ in range(n_steps):
        gl_l, gl_m = lik(x0, x1)
        d2c = (x0 - c0t) ** 2 + (x1 - c1t) ** 2
        logits = -0.5 * d2c * inv_pbw2
        p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
        psum, pc0, pc1 = lane_sum(torch.stack([p, p * c0t, p * c1t]),
                                  lanes)
        gp0 = (pc0 / psum - x0) * inv_pbw2
        gp1 = (pc1 / psum - x1) * inv_pbw2
        t0t = ((gl_l + gp0) - x0 * inv_bw2).transpose(-1, -2)
        t1t = ((gl_m + gp1) - x1 * inv_bw2).transpose(-1, -2)
        d2 = ((x0 - x0.transpose(-1, -2)) ** 2
              + (x1 - x1.transpose(-1, -2)) ** 2)
        k = torch.exp(-0.5 * d2 * inv_bw2)
        rows, drive0, drive1 = lane_sum(torch.stack([k, k * t0t, k * t1t]),
                                        lanes)
        phi0 = (drive0 + rows * x0 * inv_bw2) / m
        phi1 = (drive1 + rows * x1 * inv_bw2) / m
        x0 = x0 + lr * phi0
        x1 = x1 + lr * phi1
    return torch.cat([x0, x1], dim=-1)


@pytest.mark.parametrize("lanes,m", [(4, 50), (8, 13), (4, 7)])
def test_d_value_loop_at_two_values_equals_the_two_value_loop(lanes, m):
    """The plain MPF loop over D values (K4/K5, K14 and K2 at D = 2)
    gives the bits of the two-value loop it replaced, on the pendulum's
    likelihood gradient, over a batch of particle sets."""
    g = torch.Generator().manual_seed(m)
    x = 1.0 + 0.1 * torch.randn(3, m, 2, generator=g)
    centers = x + 0.01 * torch.randn(3, m, 2, generator=g)
    col = lambda v: torch.tensor(v).reshape(-1, 1, 1)
    bw, pbw, lr = col([0.3, 0.2, 0.5]), col([0.1, 0.4, 0.2]), col([0.01] * 3)
    lik = lambda a, b: (torch.sin(a) * b, a - 2.0 * b)
    new = mpf_ops.stein_loop_plain(x, centers, bw, pbw, lr, lik,
                                   lanes=lanes, n_steps=4)
    old = _two_value_loop(x, centers, bw, pbw, lr, lik, lanes=lanes,
                          n_steps=4)
    assert torch.equal(new, old)


# -- the generic modules against the plain version ----------------------------


class _Draws:
    """The MPF prior as the controller sees it, with its draws given."""

    def __init__(self, draws):
        self.draws = draws

    def sample(self, generator, shape):
        return self.draws

    def log_prob(self, x):
        return torch.zeros(x.shape[0])


def test_generic_modules_give_the_plain_versions_first_step():
    """MultiDisco, SVMPC and MPF as `build_particle_stack` wires them for
    the skid-steer, one MPC step on the plain version's noise (its action
    normals and its draws from the MPF prior), against the plain version's
    first step on the same injected draws: the wheel speeds, the next
    state, the policy particles after the roll, the bandwidths and the MPF
    particles to 1e-4 relative (the generic path sums costs over time and
    over the state's coordinates with torch.sum, the softmaxes and kernel
    sums in torch's order)."""
    cfg = _config()
    exp = cfg["exp_params"]
    stack = build_particle_stack(cfg, torch.Generator().manual_seed(5),
                                 device="cpu")
    assert isinstance(stack.model, SkidSteerNavigation)
    assert stack.model.uncertain_params == SKID_STEER_PARAMS
    obs = stack.init_state
    mstate = stack.mpf.init_state(stack.mpf_init, obs, 2,
                                  bw=stack.mpf_init_bw)
    svstate = stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior)
    dstate = stack.controller.init_state(stack.init_policies)

    g = torch.Generator().manual_seed(6)
    eps = torch.randn(1, 1, 2, 6, 3, 16, generator=g)
    pdz = torch.randn(1, 1, 2, 3, generator=g)
    pdu = torch.rand(1, 1, 2, generator=g)
    idx = torch.clamp(torch.floor(pdu[0, 0] * 8.0), max=7.0).long()
    # the prior's draws in the MPF's (log) space, as the controller takes
    # them from the MPF's prior
    draws = stack.mpf_init[idx] + mstate.prior_bw * pdz[0, 0]
    true = {"x_icr": 0.22, "wheel_radius": 0.06, "axial_distance": 0.5}

    bw_sv = silvermans_rule(svstate.theta)
    noise = eps[0, 0].permute(3, 2, 1, 0)            # [n_act, m, hz, 2]
    svstate, dstate, costs = stack.svmpc.svgd_step(
        svstate, dstate, obs[None], _Draws(draws), None, bw_sv, noise=noise)
    svstate, a_seq, _ = stack.svmpc.forward(svstate, costs)
    action = a_seq[0]
    new = stack.model.step(obs[None], action[None],
                           {k: torch.tensor(v) for k, v in true.items()})[0]
    mstate, _, bw_mpf = stack.mpf.optimize(mstate, action, new,
                                           bw=stack.mpf_bw)

    inputs = _inputs(stack, cfg, torch.tensor([list(true.values())]),
                     torch.zeros(1, 2, dtype=torch.int64),
                     torch.zeros(1, dtype=torch.int64), stack.mpf_init_bw)
    inputs.update(eps=eps, pdz=pdz, pdu=pdu)
    log, theta, _, _, x = se.episode_plain(inputs,
                                           _statics(stack, cfg, 1, 100))
    close = lambda a, b: torch.allclose(a, b, rtol=1e-4, atol=1e-5)
    assert close(log[0, 0, 5:7], action)
    assert close(log[0, 0, :5], new)
    assert close(log[0, 0, 10], bw_sv)
    assert close(log[0, 0, 11], torch.as_tensor(bw_mpf, dtype=torch.float32))
    assert close(theta[0], svstate.theta.reshape(3, 12))
    assert close(x[0], mstate.x)


def test_host_closed_loop_runs_the_skid_steer_stack():
    """`particle_episode_fn`, the host closed loop, runs the skid-steer
    stack: the true parameters as a dict, x_icr loaded from a quarter of
    the episode, the goal over (x, y, v, omega); the robot moves and every
    logged value is finite."""
    from dust_tpu_torch.simulation import particle_episode_fn

    cfg = _config()
    stack = build_particle_stack(cfg, torch.Generator().manual_seed(8),
                                 device="cpu")
    episode = particle_episode_fn(
        stack.model, stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        load=stack.load, steps=4, warm_up=0, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, success_dist=stack.success_dist)
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    svstate = stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior)
    state, done, crashed, cum, logs = episode(
        torch.Generator().manual_seed(9), stack.init_state,
        stack.controller.init_state(), svstate, mstate,
        {"x_icr": 0.2, "wheel_radius": 0.0625, "axial_distance": 0.475})
    states, actions, costs, parts, dones = logs
    assert states.shape == (4, 5) and actions.shape == (4, 2)
    assert parts.shape == (4, 8, 3)
    assert not torch.equal(states[-1, :2], stack.init_state[:2])
    assert all(torch.isfinite(v).all() for v in (states, actions, costs,
                                                 parts))


def test_skid_steer_task_guards():
    cfg = _config()
    arrays = _arrays(cfg, 1)
    with pytest.raises(ValueError, match="build_particle_stack"):
        build_pendulum_stack(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="particle's kernels"):
        assemble_particle_stack(_config(fused_rollout=True), arrays,
                                device="cpu")
    with pytest.raises(ValueError, match="build_pendulum_stack"):
        assemble_particle_stack({**cfg, "task": "cartpole"}, arrays,
                                device="cpu")
    with pytest.raises(ValueError, match="unknown task"):
        assemble_particle_stack({**cfg, "task": "acrobot"}, arrays,
                                device="cpu")


# -- the sweep wrapper and adapter --------------------------------------------


def _adapter(steps=3, n_sc=2, n_chains=2):
    cfg = _config()
    stack = build_particle_stack(cfg, torch.Generator().manual_seed(2),
                                 device="cpu")
    return megakernel_skid_steer_sweep_fn(stack, cfg["exp_params"], steps,
                                          n_sc, n_chains=n_chains)


def test_group_sweep_equals_per_group_calls_and_reuses_its_inputs():
    """Two groups in one call equal each group's own call bit for bit (the
    episodes key their draws on (seed, step, scenario)); a repeat call with
    the same tensors and new seeds hits the wrapper's prepared inputs and
    equals a fresh build."""
    sweep = _adapter()
    group = MegakernelGroupSweep(sweep)
    params = (torch.tensor([[0.15, 0.25], [0.2, 0.18]]),
              torch.tensor([[0.06, 0.065], [0.0625, 0.057]]),
              torch.tensor([[0.43, 0.5], [0.475, 0.52]]))
    seeds = torch.tensor([[3, 4], [5, 6]])
    out = group.run(seeds, *params)
    assert out["th"].shape == (2, 2, 3, 2)
    assert out["theta"].shape == (2, 2, 2, 3, 6, 2)
    assert out["mpf_x"].shape == (2, 2, 2, 8, 3)
    for gi in range(2):
        one = sweep(seeds[gi], *(p[gi] for p in params))
        assert all(torch.equal(out[k][gi], one[k]) for k in out)
    wrapper = sweep.wrapper
    hits, builds = wrapper.input_hits, wrapper.input_builds
    again = group.run(seeds + 1, *params)
    assert (wrapper.input_hits, wrapper.input_builds) == (hits + 1, builds)
    sse._INPUTS.clear()
    fresh = group.run(seeds + 1, *params)
    assert all(torch.equal(again[k], fresh[k]) for k in again)
    assert torch.isfinite(out["cost"]).all()


@pytest.mark.parametrize("dims,match", [
    ((17, 40, 6, 4, 64, 50), "n_sc <= 16"),
    ((8, 40, 6, 4, 64, 65), "m_mpf <= 64"),
    ((8, 40, 7, 4, 64, 50), "m\\*hz\\*2 <= 512"),
    ((8, 65, 3, 4, 64, 50), "hz\\*2<=128"),
    ((8, 40, 6, 9, 64, 50), "n_params <= 8"),
])
def test_sweep_dims_guards_raise(dims, match):
    """The skid-steer's limits, the particle sweep's numbers (two values a
    horizon step, 512 in a plan), as the shared check
    (`sweep_inputs.check_sweep_dims`) takes them, through the wrapper."""
    check = lambda *d: sweep_inputs.check_sweep_dims(
        "skid-steer sweep kernel", *d, width=2, plan_limit=512)
    check(8, 40, 6, 4, 64, 50)         # the cell's shape passes
    with pytest.raises(ValueError, match="skid-steer sweep kernel: " + match):
        check(*dims)
    cfg = _config()
    stack = build_particle_stack(cfg, torch.Generator().manual_seed(2),
                                 device="cpu")
    n_sc, hz, m, n_params, n_act, m_mpf = dims
    exp = dict(cfg["exp_params"], horizon=hz, n_particles=m,
               params_samples=n_params, action_samples=n_act,
               mpf_n_particles=m_mpf)
    sweep = megakernel_skid_steer_sweep_fn(stack, exp, 2, n_sc)
    with pytest.raises(ValueError, match="skid-steer sweep kernel: " + match):
        sweep(torch.tensor([1, 2]), torch.full((n_sc,), 0.2),
              torch.full((n_sc,), 0.0625), torch.full((n_sc,), 0.475))
