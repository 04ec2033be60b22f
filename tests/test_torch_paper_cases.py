"""The DuSt paper's pendulum cases beyond the dual loop: the `mppi`
exact-model baseline of `dust_tpu_torch` against `dust_tpu`'s.

`MultiDisco.forward(params_override=)` rolls out under the episode's
true parameters; `PendulumSimulation(use_exact_model=True)` passes them.
Both are held to JAX's from a JAX-built stack carried across, 8 steps
with injected action noise and the simulator's g = 10, at the dual
loop's per-step tolerance (rtol 1e-3, atol 5e-4).

Run as a script, this module runs `dust_tpu`'s four cases (dust, svmpc,
mppi, disco_utf) on the CPU at `demo/pendulum_config.yaml`'s width and
prints, per case, the lowest cost in the second half of the episode (the
swing-up check of `chip_smoke.py`):

    JAX_PLATFORMS=cpu python -m tests.test_torch_paper_cases [--steps 200]
"""

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.experiments import build_pendulum_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.models import PendulumModel as JPendulum
from dust_tpu.simulation import PendulumSimulation as JSim
from dust_tpu_torch.convert import (
    disco_state_from_numpy,
    stack_arrays_from_numpy,
)
from dust_tpu_torch.models import PendulumModel as TPendulum
from dust_tpu_torch.simulation import PendulumSimulation as TSim

YAML = "demo/pendulum_config.yaml"
STEPS = 8
TRUE = {"length": 1.2, "mass": 0.8}
STEP_TOL = dict(rtol=1e-3, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _mppi_stacks():
    cfg = load_config(YAML)
    cfg["exp_params"].update(horizon=10, action_samples=16)
    js = j_build(cfg, jax.random.key(0), case="mppi")
    arrays = {k: np.asarray(v) for k, v in (
        ("init_policies", js.init_policies),
        ("policies_prior.locs", js.policies_prior.locs),
        ("policies_prior.scale_tril", js.policies_prior.scale_tril),
        ("policies_prior.logits", js.policies_prior.logits),
        ("dynamics_prior.low", js.dynamics_prior.low),
        ("dynamics_prior.high", js.dynamics_prior.high),
        ("init_state", js.init_state))}
    ts = stack_arrays_from_numpy(arrays, cfg, device="cpu", case="mppi")
    assert ts.svmpc is None and ts.controller.n_pol == 1
    assert ts.model.uncertain_params is None
    return js, ts


def test_forward_with_params_override_matches_jax_step_by_step():
    js, ts = _mppi_stacks()
    jc, tc = js.controller, ts.controller
    j_sim, t_sim = JPendulum(g=10.0), TPendulum(g=10.0)
    j_true = {k: jnp.float32(v) for k, v in TRUE.items()}
    t_true = {k: torch.tensor(v) for k, v in TRUE.items()}
    noise = (2.0 * np.random.default_rng(0).normal(
        size=(STEPS, 16, 1, 10, 1))).astype(np.float32)
    jd = jc.init_state(js.init_policies)
    j_obs = jnp.asarray(np.asarray(js.init_state).reshape(1, -1))
    rows = {"costs": [], "states": [], "a_mat": [], "action": [], "obs": []}
    for t in range(STEPS):
        td = disco_state_from_numpy(jd.a_seq, jd.a_mat, jd.a_mix,
                                    device="cpu")
        t_obs = _t(j_obs)
        jd, jcost, jst, *_ = jc.forward(jd, j_obs, js.model, None,
                                        eps_noise=jnp.asarray(noise[t]),
                                        params_override=j_true)
        td, tcost, tst, *_ = tc.forward(td, t_obs, ts.model, None,
                                        eps_noise=_t(noise[t]),
                                        params_override=t_true)
        rows["a_mat"].append((td.a_mat.numpy(), np.asarray(jd.a_mat)))
        jd, ja = jc.step(jd, strategy="average")
        td, ta = tc.step(td, strategy="average")
        j_obs = j_sim.step(j_obs, ja.reshape(1, -1), j_true)
        t_obs = t_sim.step(t_obs, ta.reshape(1, -1), t_true)
        for name, a, b in (("costs", tcost, jcost), ("states", tst, jst),
                           ("action", ta, ja), ("obs", t_obs, j_obs)):
            rows[name].append((a.numpy(), np.asarray(b)))
    for name, pairs in rows.items():
        np.testing.assert_allclose(np.stack([p[0] for p in pairs]),
                                   np.stack([p[1] for p in pairs]),
                                   err_msg=name, **STEP_TOL)
    # the override reached the rollouts: the nominal model's differ
    nominal = tc.rollout(_t(j_obs), ts.model, _t(noise[0]))
    override = tc.rollout(_t(j_obs), ts.model, _t(noise[0]), t_true)
    assert np.abs(nominal.numpy() - override.numpy()).max() > 1e-2


def test_exact_model_harness_matches_jax():
    """`use_exact_model=True` through both harnesses, 8 steps, the same
    action noise every step (each controller's `sample_eps` returns it)."""
    js, ts = _mppi_stacks()
    eps = (2.0 * np.random.default_rng(1).normal(
        size=(16, 1, 10, 1))).astype(np.float32)
    js.controller.sample_eps = lambda key, shape=None: jnp.asarray(eps)
    ts.controller.sample_eps = lambda gen, shape=None: _t(eps)
    kw = dict(steps=STEPS, warm_up=0, use_svmpc=False, use_exact_model=True)
    j_df = JSim(controller=js.controller, model=js.model, **kw).run(
        jax.random.key(1), [TRUE], js.init_state, js.init_policies,
        dyn_dist=js.dynamics_prior)
    cols = TSim(controller=ts.controller, model=ts.model, device="cpu",
                **kw).run(torch.Generator().manual_seed(1), [TRUE],
                          ts.init_state, ts.init_policies,
                          dyn_dist=ts.dynamics_prior)
    for name in ("Cost", "Position", "Speed", "Actions"):
        np.testing.assert_allclose(cols[name], j_df[name].to_numpy(),
                                   err_msg=name, **STEP_TOL)
    assert np.abs(cols["Actions"]).max() > 0.5


def run_jax_cases(steps, cases, seed=0, true=None):
    """`dust_tpu`'s pendulum cases at the demo config's width: per case
    the lowest cost in steps steps//2..steps-1 and the wall seconds."""
    cfg = load_config(YAML)
    true = true or {"length": 1.0, "mass": 1.0}
    out = {}
    for case in cases:
        stack = j_build(cfg, jax.random.key(seed), case=case)
        harness = JSim(
            controller=stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
            model=stack.model, steps=steps, warm_up=0,
            use_svmpc=stack.svmpc is not None, mpf_bw=stack.mpf_bw,
            mpf_steps=stack.mpf_steps, use_exact_model=(case == "mppi"))
        t0 = time.perf_counter()
        df = harness.run(jax.random.key(seed + 1), [true], stack.init_state,
                         stack.init_policies, stack.policies_prior,
                         stack.dynamics_prior, stack.mpf_init)
        costs = df["Cost"].to_numpy()
        out[case] = {
            "min_cost_second_half": float(costs[steps // 2:].min()),
            "final_cost": float(costs[-1]),
            "finite": bool(np.isfinite(costs).all()),
            "seconds": time.perf_counter() - t0,
        }
        print(case, json.dumps(out[case]), flush=True)
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--cases", default="dust,svmpc,mppi,disco_utf")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    print(json.dumps(run_jax_cases(args.steps, args.cases.split(","),
                                   args.seed)))
