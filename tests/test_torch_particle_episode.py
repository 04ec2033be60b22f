"""K9 and the particle closed loop.

* The port's whole-episode function (whose wrapper runs the kernel's
  plain version on CPU tensors) in host-noise mode against the JAX
  `fused_particle_episode(interpret=True)` and against the port's own
  K8 + K7 composition with the simulator, the termination masks and the
  weighted-prior refresh between them (mirrors
  tests/test_pallas_particle_episode.py), at the demo width.
* The particle DuSt closed loop as `particle_episode_fn` composes it, on
  the kernel-path classes (K6 hook, `FusedParticleMPF`), against
  `dust_tpu`'s from a JAX-built stack carried across with `convert`,
  with action noise and mass draws injected and the port re-synced to the
  JAX state after every step.
* The device-RNG stream, the adapter, `run_particle_episode`.

Tolerances are tests/test_pallas_particle_episode.py:174-193's: state
and action atol 1e-5, cost and cum rtol 1e-5, bw_sv atol 1e-6, theta
1e-4, a_mat 1e-3, mpf_x 1e-5, done and crashed equal; the closed loop at
tests/test_equivalence_dual.py's (steps 0-2 rtol 1e-3, atol 5e-4)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.experiments import build_particle_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.inference.mpf import FusedParticleMPF as JFusedMPF
from dust_tpu.ops.pallas_particle_episode import (
    fused_particle_episode as j_episode,
)
from dust_tpu.ops.pallas_particle_rollout import (
    particle_kernel_statics as j_statics,
)
from dust_tpu.simulation import run_particle_episode as j_run
from dust_tpu_torch.convert import (
    disco_state_from_numpy,
    mpf_state_from_numpy,
    particle_stack_from_numpy,
    svmpc_state_from_numpy,
)
from dust_tpu_torch.experiments import (
    PARTICLE_DEMO_CONFIG,
    build_particle_stack,
)
from dust_tpu_torch.inference import FusedParticleMPF
from dust_tpu_torch.ops import particle_episode as tpe
from dust_tpu_torch.ops.bandwidth import silvermans_rule
from dust_tpu_torch.ops.particle_mpf import fused_particle_mpf_optimize
from dust_tpu_torch.ops.particle_rollout import particle_kernel_statics
from dust_tpu_torch.ops.solve import fused_particle_solve
from dust_tpu_torch.simulation import (
    megakernel_particle_episode_fn,
    run_particle_episode,
)

YAML = "demo/particle_config.yaml"
TOLS = dict(state=dict(atol=1e-5), action=dict(atol=1e-5),
            cost=dict(rtol=1e-5), cum=dict(rtol=1e-5), bw_sv=dict(atol=1e-6),
            theta=dict(atol=1e-4), a_mat=dict(atol=1e-3),
            mpf_x=dict(atol=1e-5))
EARLY_TOL = dict(rtol=1e-3, atol=5e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def stacks():
    """The demo stack built by JAX, and the port's from its arrays."""
    cfg = load_config(YAML)
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
    return cfg, js, ts


def _noise(steps, hz, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(steps, 2, hz, 8, 128)).astype(np.float32),
            rng.normal(size=(steps, 8, 128)).astype(np.float32),
            rng.uniform(size=(steps, 8, 128)).astype(np.float32))


def _episode_args(stack, conv, log_softmax):
    exp_bw = stack.mpf_init_bw
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=exp_bw)
    dstate = stack.controller.init_state()
    return (stack.init_state, stack.init_policies,
            stack.policies_prior.locs, log_softmax(stack.policies_prior.logits),
            dstate.a_mat, dstate.a_seq, stack.mpf_init, mstate.prior_bw,
            conv(stack.model.params_dict["mass"]), conv(stack.load))


def _scalars(exp):
    return (exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
            1.0 / exp["alpha"], exp["prior_sigma"], exp["mpf_learning_rate"],
            exp["mpf_obs_std"])


def _statics(exp, model, steps, warm_up, change_at, success_dist):
    return dict(steps=steps, warm_up=warm_up, hz=exp["horizon"],
                m=exp["n_particles"], n_params=exp["params_samples"],
                n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
                mpf_steps=exp["mpf_steps"], dt=float(model.dt),
                max_acc=float(model.max_acc),
                max_speed=float(model.max_speed), change_at=change_at,
                success_dist=success_dist, exp_util=True,
                weighted_prior=exp["weighted_prior"],
                mpf_log_space=exp["mpf_log_space"], use_fixed_mpf_bw=True,
                mpf_bw_scale=exp["mpf_bandwidth_scaling"])


def _run_jax(stacks, steps, warm_up, noise, change_at=100, success_dist=1.0,
             **over):
    cfg, js, _ = stacks
    exp = cfg["exp_params"]
    out = j_episode(
        jnp.zeros(2, jnp.int32),
        *_episode_args(js, jnp.float32, jax.nn.log_softmax),
        *_scalars(exp), jnp.float32(js.mpf_bw), unroll=False,
        host_eps=noise[0], host_pdz=noise[1], host_pdu=noise[2],
        interpret=True,
        **dict(_statics(exp, js.model, steps, warm_up, change_at,
                        success_dist), **over),
        **j_statics(js.model))
    return {k: np.asarray(v) for k, v in out.items()}


def _run_port(stacks, steps, warm_up, noise, change_at=100,
              success_dist=1.0, seed=(0, 0), **over):
    cfg, _, ts = stacks
    exp = cfg["exp_params"]
    nz = {} if noise is None else dict(
        host_eps=_t(noise[0]), host_pdz=_t(noise[1]), host_pdu=_t(noise[2]))
    out = tpe.fused_particle_episode(
        list(seed),
        *_episode_args(ts, float, lambda v: torch.log_softmax(v, 0)),
        *_scalars(exp), ts.mpf_bw, **nz,
        **dict(_statics(exp, ts.model, steps, warm_up, change_at,
                        success_dist), **over),
        **particle_kernel_statics(ts.model))
    return {k: v.numpy() for k, v in out.items()}


def _composition(stacks, steps, warm_up, noise, change_at=100,
                 success_dist=1.0):
    """The episode as a host loop over the port's K8 and K7 functions
    (`tests/test_pallas_particle_episode.py:_reference_composition`)."""
    cfg, _, ts = stacks
    exp = cfg["exp_params"]
    eps, pdz, pdu = noise
    m, hz = exp["n_particles"], exp["horizon"]
    n_act, n_par, mm = (exp["action_samples"], exp["params_samples"],
                        exp["mpf_n_particles"])
    sig = float(exp["ctrl_sigma"])
    model = ts.model
    statics = particle_kernel_statics(model)
    mstate = ts.mpf.init_state(ts.mpf_init, ts.init_state, 2,
                               bw=ts.mpf_init_bw)
    theta, locs = ts.init_policies, ts.policies_prior.locs
    logits = ts.policies_prior.logits
    dstate = ts.controller.init_state()
    amat, aseq = dstate.a_mat, dstate.a_seq
    x, pbw = ts.mpf_init, mstate.prior_bw
    lik_loc = state = ts.init_state
    done = crashed = False
    cum = 0.0
    base_mass = float(model.params_dict["mass"])
    logs = {k: [] for k in ("state", "action", "cost", "cum", "bw_sv")}
    for t in range(steps):
        bw_sv = silvermans_rule(theta)
        acts = torch.stack([_t(eps[t, c, :, :m, :n_act]).permute(2, 1, 0)
                            for c in (0, 1)], dim=-1)
        actions = theta[None] + sig * acts
        idx = np.minimum(np.floor(pdu[t, :n_par, 0] * mm), mm - 1).astype(int)
        masses = torch.exp(x[idx, 0] + pbw * _t(pdz[t, :n_par, 0]))
        theta_opt, theta_fwd, amat, _, a_sel, w, _ = fused_particle_solve(
            state, theta, locs, torch.log_softmax(logits, 0), amat, aseq,
            actions, masses, bw_sv, exp["learning_rate"], exp["alpha"],
            1.0 / exp["alpha"], sig, exp["prior_sigma"], hz=hz, m=m,
            n_params=n_par, n_act=n_act, dt=float(model.dt),
            max_acc=model.max_acc, max_speed=model.max_speed, **statics)
        if t >= warm_up:
            action, theta, locs = a_sel[0], theta_fwd, theta_fwd
            logits = torch.log(torch.clamp(w, min=1e-37))
        else:
            action, theta = torch.zeros(2), theta_opt
        mass = base_mass + ts.load if t >= change_at else base_mass
        new_state = model.step(state[None], action[None],
                               {"mass": torch.tensor(mass)})[0]
        state = new_state if not done else state
        if t >= warm_up and not done:
            coll = model.obst_map.get_collisions(lik_loc[0:2])
            x = fused_particle_mpf_optimize(
                x, x, lik_loc, state, action, model.dt * (1.0 - coll),
                ts.mpf_bw, pbw, exp["mpf_learning_rate"], exp["mpf_obs_std"],
                n_steps=exp["mpf_steps"], max_acc=model.max_acc,
                max_speed=model.max_speed, log_space=exp["mpf_log_space"])
            pbw, lik_loc = torch.tensor(ts.mpf_bw), state
        cost = float(model.default_inst_cost(state[None])[0])
        if not done:
            cum += cost
        crash_now = bool(model.obst_map.get_collisions(state[0:2]) > 0)
        success_now = bool(torch.linalg.norm(model.target - state)
                           <= success_dist)
        crashed = crashed or (crash_now and not done)
        done = done or crash_now or success_now
        for k, v in zip(logs, (state.numpy(), action.numpy(), cost, cum,
                               float(bw_sv))):
            logs[k].append(v)
    out = {k: np.array(v) for k, v in logs.items()}
    out.update(theta=theta.numpy(), a_mat=amat.numpy(), mpf_x=x.numpy(),
               done=done, crashed=crashed)
    return out


def _assert_close(out, ref, who, fields=tuple(TOLS)):
    for k in fields:
        np.testing.assert_allclose(out[k], ref[k], err_msg=f"{who} {k}",
                                   **TOLS[k])


@pytest.mark.parametrize("warm_up", [0, 1])
def test_episode_plain_matches_jax_and_port_composition(stacks, warm_up):
    steps = 2
    noise = _noise(steps, stacks[0]["exp_params"]["horizon"])
    out = _run_port(stacks, steps, warm_up, noise)
    j = _run_jax(stacks, steps, warm_up, noise)
    _assert_close(out, j, "jax")
    for k in ("done", "crashed", "bw_mpf"):
        np.testing.assert_array_equal(out[k], j[k], err_msg=k)
    comp = _composition(stacks, steps, warm_up, noise)
    _assert_close(out, comp, "composition")
    assert bool(out["done"][-1] > 0.5) == comp["done"]
    assert bool(out["crashed"][-1] > 0.5) == comp["crashed"]
    if warm_up:
        np.testing.assert_array_equal(out["action"][0], [0.0, 0.0])
    assert np.abs(out["action"][-1]).max() > 0.1


@pytest.mark.parametrize("seed", [5, 6])
def test_episode_plain_in_kernel_order_matches_jax(stacks, seed):
    """The plain version sums the DISCO delta over the samples in the
    kernel's 8-lane order and the MPF loop's sums in its quad order
    (`ops/particle_mpf.py:lane_sum`); over 3 steps on other noise it holds
    JAX's kernel at this file's tolerances."""
    noise = _noise(3, stacks[0]["exp_params"]["horizon"], seed=seed)
    out = _run_port(stacks, 3, 0, noise)
    j = _run_jax(stacks, 3, 0, noise)
    _assert_close(out, j, f"seed {seed}")
    for k in ("done", "crashed"):
        np.testing.assert_array_equal(out[k], j[k], err_msg=k)


@pytest.mark.parametrize("option", [
    dict(use_fixed_mpf_bw=False, mpf_bw_scale=1.3),
    dict(weighted_prior=False), dict(exp_util=False)])
def test_episode_options_match_jax(stacks, option):
    """The kernel's other settings: the Silverman MPF bandwidth, the
    unweighted prior, ExpectedCost."""
    noise = _noise(2, stacks[0]["exp_params"]["horizon"], seed=4)
    out = _run_port(stacks, 2, 0, noise, **option)
    j = _run_jax(stacks, 2, 0, noise, **option)
    _assert_close(out, j, str(option))
    np.testing.assert_allclose(out["bw_mpf"], j["bw_mpf"], atol=1e-6)
    for k in ("done", "crashed"):
        np.testing.assert_array_equal(out[k], j[k], err_msg=k)
    if "use_fixed_mpf_bw" in option:
        assert not np.allclose(out["bw_mpf"], 0.5)


def test_episode_termination_freezes(stacks):
    """A huge success radius terminates at step 0: the state freezes,
    the cumulative cost stops, and the gated MPF stops after step 0."""
    noise = _noise(3, stacks[0]["exp_params"]["horizon"], seed=2)
    out = _run_port(stacks, 3, 0, noise, success_dist=1e3)
    assert out["done"].all() and not out["crashed"].any()
    np.testing.assert_array_equal(out["state"][1], out["state"][0])
    np.testing.assert_array_equal(out["state"][2], out["state"][0])
    np.testing.assert_array_equal(out["cum"][1:], out["cum"][0])
    one = _run_port(stacks, 1, 0, tuple(n[:1] for n in noise),
                    success_dist=1e3)
    np.testing.assert_array_equal(out["mpf_x"], one["mpf_x"])


def test_crash_and_load_change_match_jax(stacks):
    """Start next to an obstacle so the episode crashes, with the load
    change at step 1: done, crashed, cost and cum as in JAX."""
    cfg, js, ts = stacks
    noise = _noise(3, cfg["exp_params"]["horizon"], seed=3)
    # push the start into the obstacle at (2, 2) with a fast velocity
    for s in (js, ts):
        s.init_state_saved = s.init_state
    try:
        js.init_state = jnp.asarray([0.93, 2.0, 5.0, 0.0], jnp.float32)
        ts.init_state = _t([0.93, 2.0, 5.0, 0.0])
        out = _run_port(stacks, 3, 0, noise, change_at=1)
        j = _run_jax(stacks, 3, 0, noise, change_at=1)
    finally:
        for s in (js, ts):
            s.init_state = s.init_state_saved
    assert out["crashed"][-1] == 1.0
    for k in ("done", "crashed"):
        np.testing.assert_array_equal(out[k], j[k], err_msg=k)
    _assert_close(out, j, "crash", fields=("state", "cost", "cum"))


def test_device_rng_episode_is_deterministic_per_seed(stacks):
    run = lambda seed: _run_port(stacks, 2, 0, None, seed=seed)
    a, b, c = run((3, 7)), run((3, 7)), run((3, 8))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.isfinite(a["cost"]).all()
    assert not np.array_equal(a["action"], c["action"])
    eps, pdz, pdu = tpe.particle_device_noise(
        torch.tensor([[3, 7]]), torch.tensor([0]), 0, hz=40, m=6, n_act=64,
        n_params=4)
    assert eps.shape == (1, 2, 40, 6, 64) and pdz.shape == pdu.shape == (1, 4)
    assert abs(float(eps.mean())) < 0.02 and abs(float(eps.std()) - 1) < 0.02
    assert float(pdu.min()) >= 0.0 and float(pdu.max()) < 1.0


def test_episode_shape_guards():
    kw = dict(steps=1, hz=40, m=6, n_params=4, n_act=64, m_mpf=50,
              mpf_steps=1, dt=0.015, max_acc=10.0, max_speed=5.0,
              weights=(1.0,) * 11, target=(0.0,) * 4, rects=None,
              grid=None, crash=False, change_at=1)
    args = ([0, 0],) + (torch.zeros(1),) * 18
    for over, match in ((dict(m=9), "m<=8"), (dict(hz=65), "hz\\*2"),
                        (dict(m_mpf=65), "m_mpf"),
                        (dict(n_params=9), "n_params")):
        with pytest.raises(ValueError, match=match):
            tpe.fused_particle_episode(*args, **dict(kw, **over))


def test_megakernel_adapter_runs_the_demo_stack():
    cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
    stack = build_particle_stack(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    episode = megakernel_particle_episode_fn(stack, cfg["exp_params"],
                                             steps=2)
    a, b = episode([0, 1]), episode([0, 1], base_mass=3.0)
    assert a["theta"].shape == (6, 40, 2) and a["mpf_x"].shape == (50, 1)
    assert a["state"].shape == (2, 4) and torch.isfinite(a["cum"]).all()
    np.testing.assert_array_equal(a["action"][0].numpy(),
                                  b["action"][0].numpy())
    assert not torch.equal(a["state"][1], b["state"][1])
    cfg["exp_params"]["mpf_bandwidth"] = None
    stack = build_particle_stack(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(ValueError, match="mpf_bandwidth"):
        megakernel_particle_episode_fn(stack, cfg["exp_params"], steps=2)


class _JDraws:
    def __init__(self, draws):
        self.draws, self.i = draws, 0

    def sample(self, key, shape):
        return jnp.asarray(self.draws[self.i])

    def log_prob(self, x):
        self.i += 1
        return jnp.zeros(x.shape[0])


class _TDraws(_JDraws):
    def sample(self, generator, shape):
        return _t(self.draws[self.i])

    def log_prob(self, x):
        self.i += 1
        return torch.zeros(x.shape[0])


def test_closed_loop_kernel_path_matches_jax_step_by_step():
    """The particle DuSt loop at reduced width through `svgd_step` with
    injected noise, forward, the simulator with the mass change and
    `FusedParticleMPF`, on the K6 hook; the port re-synced to the JAX
    state after every step."""
    cfg = load_config(YAML)
    cfg["exp_params"].update(horizon=10, action_samples=16,
                             params_samples=3, n_particles=3,
                             mpf_n_particles=12, mpf_steps=5,
                             fused_rollout=True)
    exp = cfg["exp_params"]
    js = j_build(cfg, jax.random.key(0))
    arrays = {k: np.asarray(v) for k, v in {
        "init_policies": js.init_policies,
        "policies_prior.locs": js.policies_prior.locs,
        "policies_prior.scale_tril": js.policies_prior.scale_tril,
        "policies_prior.logits": js.policies_prior.logits,
        "mpf_init": js.mpf_init, "init_state": js.init_state}.items()}
    ts = particle_stack_from_numpy(arrays, cfg, device="cpu")
    jmpf = JFusedMPF(likelihood=js.mpf.likelihood, interpret=True,
                     lr=exp["mpf_learning_rate"], n_steps=exp["mpf_steps"])
    tmpf = FusedParticleMPF.from_mpf(ts.mpf)
    steps, change_at = 4, 1
    rng = np.random.default_rng(0)
    noise = rng.normal(size=(steps, 16, 3, 10, 2)).astype(np.float32)
    draws = np.log(rng.uniform(1.7, 2.4, (steps, 3, 1))).astype(np.float32)
    j_draws, t_draws = _JDraws(draws), _TDraws(draws)

    j_obs = js.init_state
    jsv = js.svmpc.init_state(js.init_policies, js.policies_prior)
    jd = js.controller.init_state()
    jms = jmpf.init_state(js.mpf_init, j_obs, 2, bw=js.mpf_init_bw)
    tsv = ts.svmpc.init_state(ts.init_policies, ts.policies_prior)
    td = ts.controller.init_state()
    tms = tmpf.init_state(ts.mpf_init, ts.init_state, 2, bw=ts.mpf_init_bw)
    key = jax.random.key(1)  # unused: all noise injected
    rows = {k: [] for k in ("action", "obs", "mpf_x", "theta", "costs")}
    for t in range(steps):
        t_obs = _t(j_obs)
        jbw = silvermans_rule(_t(jsv.theta))
        jsv, jd, jc = js.svmpc.svgd_step(jsv, jd, j_obs[None], j_draws, key,
                                         jnp.asarray(jbw.numpy()),
                                         noise=jnp.asarray(noise[t]))
        tsv, td, tc = ts.svmpc.svgd_step(tsv, td, t_obs[None], t_draws, None,
                                         silvermans_rule(tsv.theta),
                                         noise=_t(noise[t]))
        jsv, ja, _ = js.svmpc.forward(jsv, jc)
        tsv, ta, _ = ts.svmpc.forward(tsv, tc)
        mass = 2.0 + (ts.load if t >= change_at else 0.0)
        j_obs = js.model.step(j_obs[None], ja[0][None],
                              {"mass": jnp.float32(mass)})[0]
        t_obs = ts.model.step(t_obs[None], ta[0][None],
                              {"mass": torch.tensor(mass)})[0]
        jms, _, _ = jmpf.optimize(jms, ja[0], j_obs, bw=js.mpf_bw)
        tms, _, _ = tmpf.optimize(tms, ta[0], t_obs, bw=ts.mpf_bw)
        for name, a, b in (("action", ta[0], ja[0]), ("obs", t_obs, j_obs),
                           ("mpf_x", tms.x, jms.x),
                           ("theta", tsv.theta, jsv.theta),
                           ("costs", tc, jc)):
            rows[name].append((a.numpy(), np.asarray(b)))
        # re-sync: the next step starts from the JAX state on both sides
        tsv = svmpc_state_from_numpy(jsv.theta, jsv.prior.locs,
                                     jsv.prior.scale_tril, jsv.prior.logits,
                                     jsv.prior_updated, device="cpu")
        td = disco_state_from_numpy(jd.a_seq, jd.a_mat, jd.a_mix,
                                    device="cpu")
        tms = mpf_state_from_numpy(jms.x, jms.prior.locs,
                                   jms.prior.scale_tril, jms.prior.logits,
                                   jms.lik.loc, jms.lik.past_obs,
                                   jms.lik.past_action, jms.prior_bw,
                                   device="cpu")
    for name, pairs in rows.items():
        ours = np.stack([p[0] for p in pairs])
        theirs = np.stack([p[1] for p in pairs])
        tol = dict(rtol=2e-5, atol=2e-3) if name == "costs" else EARLY_TOL
        np.testing.assert_allclose(ours, theirs, err_msg=name, **tol)
    assert np.abs(np.stack([p[1] for p in rows["action"]])).max() > 0.5


def test_run_particle_episode_outcome_schema(stacks):
    """`run_particle_episode` returns JAX's outcome dict: the same keys,
    a trajectory cut at termination, cum_cost = inf on a crash."""
    cfg, js, ts = stacks
    kw = dict(load=1.0, steps=2, warm_up=0, mpf_bw=0.5, mpf_steps=2)
    j = j_run(jax.random.key(0), js.model, js.controller, js.svmpc,
              js.svmpc.init_state(js.init_policies, js.policies_prior),
              js.mpf, js.mpf.init_state(js.mpf_init, js.init_state, 2,
                                        bw=js.mpf_init_bw),
              js.dynamics_prior, **kw)
    t = run_particle_episode(
        torch.Generator().manual_seed(0), ts.model, ts.controller, ts.svmpc,
        ts.svmpc.init_state(ts.init_policies, ts.policies_prior), ts.mpf,
        ts.mpf.init_state(ts.mpf_init, ts.init_state, 2, bw=ts.mpf_init_bw),
        ts.dynamics_prior, **kw)
    assert set(t) == set(j)
    for k in ("trajectory", "actions", "costs", "dyn_particles",
              "final_state"):
        assert t[k].shape == np.asarray(j[k]).shape, k
    assert (t["steps"], t["crashed"], t["success"]) == (2, False, False)
    assert np.isfinite(t["cum_cost"])
    # without SVMPC the controller's own argmax plan acts (MPPI-style)
    c = run_particle_episode(
        torch.Generator().manual_seed(0), ts.model, ts.controller,
        mpf=ts.mpf, mstate=ts.mpf.init_state(ts.mpf_init, ts.init_state, 2,
                                             bw=ts.mpf_init_bw),
        dyn_dist=ts.dynamics_prior, use_svmpc=False, **kw)
    assert c["steps"] == 2 and np.isfinite(c["trajectory"]).all()
    assert np.abs(c["actions"]).max() > 0.0
    assert np.abs(c["actions"]).max() <= 10.0     # clamped to max_accel
