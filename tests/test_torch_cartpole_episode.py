"""K14 and its plain version (`ops/cartpole_episode.py`): the plain
version against the benchmark's plain reference
(`perfbench/reference/cartpole.py`) through the tip load, the hand-derived
likelihood gradient against `torch.autograd` through
`models.CartPoleModel.step`, the generic modules of
`assemble_stack(task="cartpole")` against the plain version's first step
on the same noise, and the sweep wrapper and adapter
(`ops/cartpole_sweep_episode.py`, `simulation.megakernel_cartpole_sweep_fn`).
The kernel itself runs only on the card (chip_smoke.py, phase 41)."""

import copy
import json
import math

import pytest
import torch

from dust_tpu_torch.experiments import (
    CARTPOLE_DEMO_CONFIG,
    assemble_stack,
    build_pendulum_stack,
    draw_stack_arrays,
)
from dust_tpu_torch.inference.likelihoods import (
    GaussianLikelihood,
    LikelihoodState,
)
from dust_tpu_torch.models import CartPoleModel
from dust_tpu_torch.ops import cartpole_episode as ce
from dust_tpu_torch.ops import cartpole_sweep_episode as cse
from dust_tpu_torch.ops import sweep_inputs
from dust_tpu_torch.ops.bandwidth import silvermans_rule
from dust_tpu_torch.ops.episode import device_noise
from dust_tpu_torch.parallel import MegakernelGroupSweep
from dust_tpu_torch.simulation import megakernel_cartpole_sweep_fn
from perfbench.harness import ROOT
from perfbench.reference import cartpole as ref

MODEL = {k: CARTPOLE_DEMO_CONFIG["model_params"][k] for k in ce.MODEL_KEYS}
DT = CARTPOLE_DEMO_CONFIG["model_params"]["dt"]
SMALL = dict(horizon=6, action_samples=16, params_samples=2, n_particles=3,
             mpf_n_particles=8, mpf_steps=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**exp):
    cfg = copy.deepcopy(CARTPOLE_DEMO_CONFIG)
    cfg["exp_params"].update(SMALL, **exp)
    return cfg


def _arrays(cfg, seed):
    """Seeded random initial arrays: policies, their prior's locations, the
    MPF particles from the prior, the hanging start."""
    return draw_stack_arrays(cfg, torch.Generator().manual_seed(seed),
                             device="cpu")


# -- the plain version against the reference -------------------------------------


def test_demo_config_is_the_benchmarks_configuration():
    """`CARTPOLE_DEMO_CONFIG` is the benchmark's configuration file's
    content, its prior beside it."""
    f = json.loads((ROOT / "perfbench" / "configs" / "cartpole.json")
                   .read_text())
    assert CARTPOLE_DEMO_CONFIG == {**f["config"],
                                    "dynamics_prior": f["dynamics_prior"]}
    assert (f["task"], f["case"], f["reduced"]) == ("cartpole", "dust", [])


@pytest.mark.parametrize("noise", ["injected", "device_rng"])
def test_plain_version_equals_the_reference_through_the_load(noise):
    """2 groups x 2 scenarios x 1 chain, horizon 6, 16 samples, 2 draws, 3
    plans, 8 MPF particles x 3 Stein steps, K = 5 steps with the tip load
    from step 2. With `injected` noise the plain version reads the
    reference's draws as tensors, its test seam. States, actions, costs and
    bandwidths: equal to 1e-6 relative of their size, as the two share
    the step's order of operations (the CPU's sin and cos on both); the
    MPF particles to 1e-5: the reference takes the likelihood gradient by
    autograd, the plain version by hand, which differ by rounding."""
    cfg = _config(load_step=2)
    exp = cfg["exp_params"]
    arrays = _arrays(cfg, 7)
    G, n_sc, K = 2, 2, 5
    seeds = torch.tensor([[11, 3], [12, 5]])
    lens = torch.tensor([[0.8, 1.2], [1.05, 0.9]])
    mps = torch.tensor([[0.12, 0.08], [0.1, 0.11]])
    ep = ref.sweep_inputs(exp, arrays, seeds, lens, mps, 1, torch.float32)
    want = ref.sweep_reference(
        cfg, {**arrays, "theta0": arrays["init_policies"][..., 0],
              "locs0": arrays["policies_prior.locs"][..., 0]}, ep, K)

    stack = assemble_stack(cfg, arrays, device="cpu")
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 1)
    B = G * n_sc
    per_ep = lambda v: v[..., 0].reshape(1, 3, 6).expand(B, 3, 6)
    inputs = dict(
        scal=ce.cartpole_scal(stack.init_state, exp["ctrl_sigma"],
                              exp["learning_rate"], exp["alpha"],
                              1.0 / exp["alpha"], exp["prior_sigma"],
                              exp["mpf_learning_rate"], exp["mpf_obs_std"],
                              mstate.prior_bw, 3, "cpu"),
        ep_f=torch.stack([ep["length"], ep["mass_pole"]], dim=-1),
        seeds=ep["seeds"], scenario=ep["scenario"],
        theta0=per_ep(stack.init_policies),
        locs0=per_ep(stack.policies_prior.locs),
        amat0=torch.zeros(B, 3, 6),
        mpfx0=stack.mpf_init[None].expand(B, 8, 2),
        eps=None, pdz=None, pdu=None)
    if noise == "injected":
        draws = [device_noise(ep["seeds"], ep["scenario"], t, 6, 3, 16, 2)
                 for t in range(K)]
        for i, k in enumerate(("eps", "pdz", "pdu")):
            inputs[k] = torch.stack([d[i] for d in draws], dim=1)
    st = ce.episode_statics(K, 6, 3, 2, 16, 8, 3, DT, MODEL, 2, 2.0,
                            True, exp["mpf_log_space"], None, 1.0)
    log, _, _, _, x = ce.episode_plain(inputs, st)
    for i, f in enumerate(ce.LOG_FIELDS):
        w = want[f]
        scale = w.abs() + w.abs().mean()
        assert ((log[..., i] - w).abs() <= 1e-6 * scale).all(), f
    # the load doubled the pole mass from step 2: the simulator differs
    # from an unloaded step there
    unloaded = ref.step(torch.stack([want[f][:, 1] for f in
                                     ce.LOG_FIELDS[:4]], -1),
                        want["action"][:, 2], ep["length"], ep["mass_pole"],
                        cfg["model_params"])
    assert not torch.allclose(unloaded[:, 3], want["th_dot"][:, 2])
    _, want_x = ref.mpf_chain(cfg, arrays, want)
    assert torch.allclose(x, want_x, rtol=1e-5, atol=1e-5)


# -- the likelihood gradient --------------------------------------------------------


def _transitions(dtype):
    """States near hanging, near upright and with the cart moving (x_dot
    != 0, both signs), the action of each, and the observed next states
    from the model's defaults."""
    g = torch.Generator().manual_seed(3)
    r = lambda n, s: s * torch.randn(n, generator=g, dtype=dtype)
    n = 6
    th = torch.cat([math.pi + r(2, 0.1), r(2, 0.1), r(2, 1.5)])
    s0 = torch.stack([r(n, 0.5), torch.tensor([0.0, 0.4, -0.3, 1.2, -2.0,
                                               0.7], dtype=dtype), th,
                      r(n, 2.0)], dim=-1)
    action = torch.tensor([0.3, -1.4, 0.9, 0.0, -0.5, 1.0], dtype=dtype)
    model = CartPoleModel(uncertain_params=("length", "mass_pole"),
                          device="cpu")
    s1 = model.step(s0, action[:, None]) + r(n * 4, 0.05).reshape(n, 4)
    return s0, action, s1


@pytest.mark.parametrize("log_space", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 2e-4)])
def test_lik_grad_equals_autograd_through_the_model(log_space, dtype, tol):
    """The hand-derived gradient of the MPF's Gaussian observation
    log-likelihood (`lik_grad`, K14's CartPoleLik) against torch.autograd
    through `CartPoleModel.step` and `GaussianLikelihood.log_prob`, at
    random (length, mass_pole) particles. In float64 the two agree to
    1e-10 relative (the algebra); in float32 to 2e-4 of the gradient's
    largest size (the rounding of a quotient's derivative)."""
    s0, action, s1 = _transitions(dtype)
    g = torch.Generator().manual_seed(4)
    x = torch.stack([0.5 + torch.rand(5, 20, generator=g, dtype=dtype),
                     0.05 + 0.25 * torch.rand(5, 20, generator=g,
                                              dtype=dtype)], dim=-1)
    x = torch.cat([x, x[:1]])                       # one set per transition
    if log_space:
        x = torch.log(x)
    sigma = torch.full((6,), 0.1, dtype=dtype)
    lik = ce.lik_grad(s0, action, s1, sigma, MODEL, DT, log_space)
    gl0, gl1 = lik(x[..., 0:1], x[..., 1:2])
    got = torch.cat([gl0, gl1], dim=-1)

    model = CartPoleModel(uncertain_params=("length", "mass_pole"),
                          device="cpu")
    gauss = GaussianLikelihood(0.1, model, log_space=log_space)
    want = []
    for b in range(6):
        state = LikelihoodState(loc=s1[b], past_obs=s0[b],
                                past_action=action[b:b + 1])
        xb = x[b].clone().requires_grad_(True)
        pred = gauss.sample(state, xb)
        (grad,) = torch.autograd.grad(gauss.log_prob(state, pred).sum(), xb)
        want.append(grad)
    want = torch.stack(want)
    assert torch.isfinite(got).all()
    scale = want.abs().amax(dim=(1, 2), keepdim=True)
    assert ((got - want).abs() <= tol * scale).all()


# -- the generic modules against the plain version ----------------------------------


class _Draws:
    """The MPF prior as the controller sees it, with its draws given."""

    def __init__(self, draws):
        self.draws = draws

    def sample(self, generator, shape):
        return self.draws

    def log_prob(self, x):
        return torch.zeros(x.shape[0])


def test_generic_modules_give_the_plain_versions_first_step():
    """MultiDisco, SVMPC and MPF as `assemble_stack` wires them for the
    cart-pole, one MPC step on the plain version's noise (its action
    normals and its draws from the MPF prior), against the plain version's
    first step on the same injected draws: the action, the next state, the policy
    particles after the roll, both bandwidths and the MPF particles to
    1e-4 relative (the generic path sums costs over time with torch.sum,
    the softmaxes and kernel sums in torch's order)."""
    cfg = _config()
    exp = cfg["exp_params"]
    stack = build_pendulum_stack(cfg, torch.Generator().manual_seed(5),
                                 device="cpu")
    assert isinstance(stack.model, CartPoleModel)
    assert stack.model.uncertain_params == ("length", "mass_pole")
    obs = stack.init_state
    m0 = stack.mpf.init_state(stack.mpf_init, obs, 1)
    # an isotropic prior, as the kernel keeps it
    mstate = stack.mpf.init_state(stack.mpf_init, obs, 1, bw=m0.prior_bw)
    svstate = stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior)
    dstate = stack.controller.init_state(stack.init_policies)

    g = torch.Generator().manual_seed(6)
    eps = torch.randn(1, 1, 6, 3, 16, generator=g)
    pdz = torch.randn(1, 1, 2, 2, generator=g)
    pdu = torch.rand(1, 1, 2, generator=g)
    idx = torch.clamp(torch.floor(pdu[0, 0] * 8.0), max=7.0).long()
    # the prior's draws in the MPF's (log) space, as the controller takes
    # them from the MPF's prior
    draws = stack.mpf_init[idx] + mstate.prior_bw * pdz[0, 0]
    true_l, true_mp = 1.1, 0.09

    bw_sv = silvermans_rule(svstate.theta)
    noise = eps[0, 0].permute(2, 1, 0)[..., None]         # [n_act, m, hz, 1]
    svstate, dstate, costs = stack.svmpc.svgd_step(
        svstate, dstate, obs[None], _Draws(draws), None, bw_sv, noise=noise)
    svstate, a_seq, _ = stack.svmpc.forward(svstate, costs)
    action = a_seq[0]
    sim = CartPoleModel(device="cpu", **cfg["model_params"])
    new = sim.step(obs[None], action[None],
                   {"length": torch.tensor(true_l),
                    "mass_pole": torch.tensor(true_mp)})[0]
    mstate, _, bw_mpf = stack.mpf.optimize(mstate, action, new)

    inputs = dict(
        scal=ce.cartpole_scal(obs, exp["ctrl_sigma"], exp["learning_rate"],
                              exp["alpha"], 1.0 / exp["alpha"],
                              exp["prior_sigma"], exp["mpf_learning_rate"],
                              exp["mpf_obs_std"], m0.prior_bw, 3, "cpu"),
        ep_f=torch.tensor([[true_l, true_mp]]),
        seeds=torch.zeros(1, 2, dtype=torch.int64),
        scenario=torch.zeros(1, dtype=torch.int64),
        theta0=stack.init_policies[..., 0][None],
        locs0=stack.policies_prior.locs[..., 0][None],
        amat0=torch.zeros(1, 3, 6),
        mpfx0=stack.mpf_init[None], eps=eps, pdz=pdz, pdu=pdu)
    st = ce.episode_statics(1, 6, 3, 2, 16, 8, 3, DT, MODEL, 100, 2.0,
                            True, exp["mpf_log_space"], None, 1.0)
    log, theta, _, _, x = ce.episode_plain(inputs, st)
    close = lambda a, b: torch.allclose(a, b, rtol=1e-4, atol=1e-5)
    assert close(log[0, 0, 4], action)
    assert close(log[0, 0, :4], new)
    assert close(log[0, 0, 6], bw_sv)
    assert close(log[0, 0, 7], torch.as_tensor(bw_mpf))
    assert close(theta[0], svstate.theta[..., 0])
    assert close(x[0], mstate.x)


def test_cartpole_task_guards():
    cfg = _config()
    arrays = _arrays(cfg, 1)
    with pytest.raises(ValueError, match="dust case only"):
        assemble_stack(cfg, arrays, case="svmpc", device="cpu")
    with pytest.raises(ValueError, match="pendulum's kernels"):
        assemble_stack(_config(fused_rollout=True), arrays, device="cpu")
    with pytest.raises(ValueError, match="unknown task"):
        assemble_stack({**cfg, "task": "acrobot"}, arrays, device="cpu")


# -- the sweep wrapper and adapter ----------------------------------------------------


def _adapter(steps=3, n_sc=2, n_chains=2, **kw):
    cfg = _config(load_step=1)
    stack = build_pendulum_stack(cfg, torch.Generator().manual_seed(2),
                                 device="cpu")
    return megakernel_cartpole_sweep_fn(stack, cfg["exp_params"], steps,
                                        n_sc, n_chains=n_chains, **kw)


def test_group_sweep_equals_per_group_calls_and_reuses_its_inputs():
    """Two groups in one call equal each group's own call bit for bit (the
    episodes key their draws on (seed, step, scenario)); a repeat call with
    the same tensors and new seeds hits the wrapper's prepared inputs and
    equals a fresh build."""
    sweep = _adapter()
    group = MegakernelGroupSweep(sweep)
    lens = torch.tensor([[0.9, 1.1], [1.0, 1.2]])
    mps = torch.tensor([[0.1, 0.12], [0.08, 0.1]])
    seeds = torch.tensor([[3, 4], [5, 6]])
    out = group.run(seeds, lens, mps)
    assert out["th"].shape == (2, 2, 3, 2) and out["mpf_x"].shape == (
        2, 2, 2, 8, 2)
    for gi in range(2):
        one = sweep(seeds[gi], lens[gi], mps[gi])
        assert all(torch.equal(out[k][gi], one[k]) for k in out)
    wrapper = sweep.wrapper
    hits, builds = wrapper.input_hits, wrapper.input_builds
    again = group.run(seeds + 1, lens, mps)
    assert (wrapper.input_hits, wrapper.input_builds) == (hits + 1, builds)
    cse._INPUTS.clear()
    fresh = group.run(seeds + 1, lens, mps)
    assert all(torch.equal(again[k], fresh[k]) for k in again)
    assert torch.isfinite(out["cost"]).all()


def test_sweep_dims_guards_raise():
    """The cart-pole's limits, the pendulum sweep's numbers, as the shared
    check (`sweep_inputs.check_sweep_dims`) takes them."""
    check = lambda *dims: sweep_inputs.check_sweep_dims(
        "cartpole sweep kernel", *dims)
    with pytest.raises(ValueError, match="cartpole sweep kernel: n_sc <= 16"):
        check(17, 30, 3, 8, 128, 50)
    with pytest.raises(ValueError, match="cartpole sweep kernel: m_mpf <= 64"):
        check(16, 30, 3, 8, 128, 65)
    with pytest.raises(ValueError, match="m\\*hz <= 128"):
        check(16, 60, 3, 8, 128, 50)
