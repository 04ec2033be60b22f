"""`dust_tpu_torch.parallel.ScenarioSweep`: the pendulum episode over
scenarios, one after another.

Each scenario is bit-equal to its own `PendulumSimulation.episode_fn` run
from the same seed (the sweep's episodes start from states that
`broadcast_scenarios` shares, and leave them as they were); a NaN true
length spoils its own scenario only; the NaN-aware reductions equal
those of `dust_tpu`'s `ScenarioSweep` on the same cost arrays. The
episodes run at a reduced width, 4 steps, on the kernel path's classes
(the K1 hook and `FusedPendulumMPF`, their plain versions here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.experiments import load_config
from dust_tpu.parallel.sweep import ScenarioSweep as JSweep
from dust_tpu_torch.experiments import build_pendulum_stack
from dust_tpu_torch.inference import FusedPendulumMPF
from dust_tpu_torch.parallel import ScenarioSweep, broadcast_scenarios
from dust_tpu_torch.simulation import PendulumSimulation

STEPS = 4
N = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _harness():
    cfg = load_config("demo/pendulum_config.yaml")
    cfg["exp_params"].update(horizon=8, action_samples=16, params_samples=4,
                             mpf_n_particles=12, mpf_steps=3,
                             fused_rollout=True)
    stack = build_pendulum_stack(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    stack.mpf = FusedPendulumMPF.from_mpf(stack.mpf)
    harness = PendulumSimulation(
        controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        model=stack.model, steps=STEPS, warm_up=1, mpf_bw=stack.mpf_bw,
        mpf_steps=stack.mpf_steps, device="cpu")
    init_obs = stack.init_state.reshape(1, -1)
    states = (stack.controller.init_state(stack.init_policies),
              stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior),
              stack.mpf.init_state(stack.mpf_init, init_obs[0], 1))
    return stack, harness, init_obs, states


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__
                for t in _tensors(getattr(tree, f))]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def test_each_scenario_equals_its_own_episode_and_nan_stays_put():
    stack, harness, init_obs, states = _harness()
    seeds = [11, 12, 13]
    lengths = torch.tensor([1.0, float("nan"), 0.8])
    masses = torch.tensor([1.0, 1.1, 0.9])
    before = [t.clone() for t in _tensors(states)]
    sweep = ScenarioSweep(harness, device="cpu")
    out = sweep.run(seeds, {"length": lengths, "mass": masses},
                    init_obs.expand(N, 1, 2),
                    *(broadcast_scenarios(s, N) for s in states))
    assert out["costs"].shape == (N, STEPS)
    assert out["states"].shape == (N, STEPS, 2)
    assert out["actions"].shape == (N, STEPS, 1)
    # the shared initial states were not written to
    for a, b in zip(_tensors(states), before):
        assert torch.equal(a, b)
    episode = harness.episode_fn(None)
    for i in range(N):
        _, logs = episode(torch.Generator().manual_seed(seeds[i]),
                          {"length": lengths[i], "mass": masses[i]},
                          init_obs, *states)
        for name, j in (("states", 0), ("actions", 1), ("costs", 2)):
            np.testing.assert_array_equal(out[name][i].numpy(),
                                          logs[j].numpy(),
                                          err_msg=f"{name} {i}")
    assert out["healthy"].tolist() == [True, False, True]
    assert np.isnan(out["costs"][1].numpy()).any()
    want = out["avg_cum_cost"][[0, 2]].mean()
    np.testing.assert_allclose(float(out["mean_cost_healthy"]), float(want),
                               rtol=1e-6)


class _JHarness:
    """Episodes whose costs are the `costs` entry of the true parameters."""

    def episode_fn(self, static_dyn_dist):
        def episode(key, true_params, init_obs, dstate, svstate, mstate):
            c = true_params["costs"]
            return init_obs, (jnp.zeros((c.shape[0], 2)),
                              jnp.zeros((c.shape[0], 1)), c)
        return episode


class _THarness:
    device = torch.device("cpu")

    def episode_fn(self, static_dyn_dist):
        def episode(gen, true_params, init_obs, dstate, svstate, mstate):
            c = true_params["costs"]
            return init_obs, (torch.zeros((c.shape[0], 2)),
                              torch.zeros((c.shape[0], 1)), c)
        return episode


@pytest.mark.parametrize("nan_rows", [(2,), (), (0, 1, 2, 3, 4)])
def test_reductions_match_jax(nan_rows):
    costs = np.random.default_rng(0).gamma(
        2.0, 30.0, size=(5, 200)).astype(np.float32)
    for r in nan_rows:
        costs[r, 17 + r] = np.nan
    j = JSweep(_JHarness()).run(
        jax.random.split(jax.random.key(0), 5), {"costs": jnp.asarray(costs)},
        jnp.zeros((5, 1, 2)), jnp.zeros(5), jnp.zeros(5), jnp.zeros(5))
    t = ScenarioSweep(_THarness(), device="cpu").run(
        list(range(5)), {"costs": torch.tensor(costs)},
        torch.zeros((5, 1, 2)), *([None] * 5,) * 3)
    np.testing.assert_array_equal(t["healthy"].numpy(),
                                  np.asarray(j["healthy"]))
    np.testing.assert_allclose(t["avg_cum_cost"].numpy(),
                               np.asarray(j["avg_cum_cost"]), rtol=1e-6)
    np.testing.assert_allclose(float(t["mean_cost_healthy"]),
                               float(j["mean_cost_healthy"]), rtol=1e-6)
    assert np.isnan(float(t["mean_cost_healthy"])) == (len(nan_rows) == 5)


def test_mesh_and_mismatched_inputs_raise():
    with pytest.raises(NotImplementedError, match="mesh"):
        ScenarioSweep(_THarness(), mesh=object(), device="cpu")
    sweep = ScenarioSweep(_THarness(), device="cpu")
    with pytest.raises(ValueError, match="2 scenarios"):
        sweep.run([0, 1], {"costs": torch.zeros((2, 3))},
                  torch.zeros((3, 1, 2)), [None] * 2, [None] * 2, [None] * 2)


@pytest.mark.parametrize("cov", [[[np.nan, 0.0], [0.0, np.nan]],
                                 [[1.0, 0.0], [0.0, -1.0]],
                                 [[0.5, 0.1], [0.1, 0.3]]],
                         ids=["nan", "indefinite", "pd"])
def test_cholesky_of_a_bad_covariance_is_nan_as_in_jax(cov):
    """A NaN or indefinite covariance (a diverged scenario's MPF
    bandwidth) gives a NaN factor, as `jnp.linalg.cholesky` does; the
    port's priors raised here before, which stopped the whole sweep."""
    from dust_tpu.distributions import GMM as JGMM
    from dust_tpu_torch.distributions import GMM, MVN

    cov = np.asarray(cov, np.float32)
    want = np.asarray(JGMM.from_cov(jnp.zeros((3, 2)), jnp.ones(3),
                                    jnp.asarray(cov)).scale_tril)
    got = GMM.from_cov(torch.zeros((3, 2)), torch.ones(3),
                       torch.tensor(cov)).scale_tril.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        MVN.from_cov(torch.zeros(2), torch.tensor(cov)).scale_tril.numpy(),
        want, rtol=1e-6)
