"""K10 and its adapters: the port's particle scenario sweep (whose wrapper
runs the plain version on CPU tensors) against the JAX
`fused_particle_sweep_episode(interpret=True)` and against independent
port single episodes; multi-chain runs and the chain seeds; scenario
isolation under NaN; the adapter guards; `MegakernelGroupSweep`; and
`ParticleScenarioSweep` (mirrors tests/test_pallas_particle_sweep.py and
tests/test_particle_sweep.py, without the device mesh).

Tolerances: against JAX, tests/test_pallas_particle_sweep.py:67-72 and
:126-169 (the TPU sweep reassociates the Stein step into centered Gram
matrices, where the port repeats the single-episode arithmetic); against
the port's own single episodes and across chains and groups, bit for bit
(each scenario is one episode of the same code)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.experiments import build_particle_stack as j_build
from dust_tpu.experiments import load_config
from dust_tpu.simulation import megakernel_particle_sweep_fn as j_sweep_fn
from dust_tpu_torch.convert import particle_stack_from_numpy
from dust_tpu_torch.experiments import (
    PARTICLE_DEMO_CONFIG,
    build_particle_stack,
)
from dust_tpu_torch.ops import particle_sweep_episode as tps
from dust_tpu_torch.ops.particle_episode import fused_particle_episode
from dust_tpu_torch.ops.particle_rollout import particle_kernel_statics
from dust_tpu_torch.parallel import (
    MegakernelGroupSweep,
    ParticleScenarioSweep,
    broadcast_scenarios,
)
from dust_tpu_torch.simulation import (
    megakernel_particle_sweep_fn,
    particle_episode_fn,
    run_particle_episode,
)

YAML = "demo/particle_config.yaml"
# tests/test_pallas_particle_sweep.py:67-72, :126-169 (the CPU values)
TOLS = {"px": dict(rtol=1e-4, atol=1e-3), "py": dict(rtol=1e-4, atol=1e-3),
        "vx": dict(rtol=1e-4, atol=1e-3), "vy": dict(rtol=1e-4, atol=1e-3),
        "a_x": dict(rtol=1e-3, atol=1e-3), "a_y": dict(rtol=1e-3, atol=1e-3),
        "cost": dict(rtol=2e-3, atol=1.0),
        "bw_sv": dict(rtol=1e-4, atol=1e-6),
        "bw_mpf": dict(rtol=1e-4, atol=1e-6),
        "theta": dict(rtol=1e-3, atol=5e-3),
        "mpf_x": dict(rtol=1e-4, atol=1e-5)}
LOGS = ("px", "py", "vx", "vy", "a_x", "a_y", "cost", "done", "crashed",
        "cum", "bw_sv", "bw_mpf")
FINAL = ("theta", "locs", "a_mat", "log_mix", "mpf_x")


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


def _noise(n_sc, steps, seed=0, lead=()):
    """Host noise in the JAX sweep layout: eps [steps, hz, 2, smp, 128],
    pdz/pdu [steps, n_sc, 8, 128], with a leading `lead` shape."""
    rng = np.random.default_rng(seed)
    smp = -(-n_sc * 6 // 8) * 8
    lead = tuple(lead)
    return (rng.normal(size=lead + (steps, 40, 2, smp, 128)).astype(np.float32),
            rng.normal(size=lead + (steps, n_sc, 8, 128)).astype(np.float32),
            rng.uniform(size=lead + (steps, n_sc, 8, 128)).astype(np.float32))


def _masses(n_sc):
    return np.linspace(1.6, 2.4, n_sc).astype(np.float32)


def _port_sweep(stack, cfg, n_sc, steps, noise, masses=None, seed=(0, 0),
                **kw):
    sweep = megakernel_particle_sweep_fn(stack, cfg["exp_params"],
                                         steps=steps, n_sc=n_sc, **kw)
    nz = {} if noise is None else dict(host_eps=_t(noise[0]),
                                       host_pdz=_t(noise[1]),
                                       host_pdu=_t(noise[2]))
    masses = _masses(n_sc) if masses is None else masses
    return sweep(list(seed), _t(masses), **nz)


@pytest.mark.parametrize("n_sc", [2, 3, 9])
def test_sweep_plain_matches_jax(stacks, n_sc):
    """n_sc = 9 takes the TPU kernel's widened 16-scenario tiles. Noise
    from numpy seed 0 for every n_sc: with seed 9 at n_sc = 9 one
    scenario's bw_sv after the demo's lr = 100 Stein step lands 2.2e-4
    (relative) from JAX's, the near-tie amplification that
    tests/test_pallas_particle_sweep.py:184-190 describes between the TPU
    sweep and its single episodes."""
    cfg, js, ts = stacks
    steps = 2
    noise = _noise(n_sc, steps, seed=0)
    j = j_sweep_fn(js, cfg["exp_params"], steps=steps, n_sc=n_sc,
                   unroll=False, interpret=True)(
        jnp.zeros(2, jnp.int32), jnp.asarray(_masses(n_sc)),
        host_eps=noise[0], host_pdz=noise[1], host_pdu=noise[2])
    t = _port_sweep(ts, cfg, n_sc, steps, noise)
    assert set(t) == set(j)
    for k in t:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
    for k, tol in TOLS.items():
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   err_msg=k, **tol)
    for k in ("done", "crashed"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    np.testing.assert_allclose(t["cum"].numpy(), np.asarray(j["cum"]),
                               **TOLS["cost"])


def _single_noise(noise, s, m=6):
    """Scenario s's slices in the single-episode layout: host_eps
    [steps, 2, hz, 8, 128] (rows q < m), host_pdz/host_pdu
    [steps, 8, 128]."""
    eps, pdz, pdu = noise
    steps, hz = eps.shape[0], eps.shape[1]
    eps_s = np.zeros((steps, 2, hz, 8, 128), np.float32)
    eps_s[:, :, :, :m] = eps[:, :, :, s * m:(s + 1) * m].transpose(
        0, 2, 1, 3, 4)
    return eps_s, pdz[:, s], pdu[:, s]


def _port_single(stack, cfg, steps, noise_s, mass, seed=(0, 0)):
    exp = cfg["exp_params"]
    model = stack.model
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    dstate = stack.controller.init_state()
    nz = {} if noise_s is None else dict(host_eps=_t(noise_s[0]),
                                         host_pdz=_t(noise_s[1]),
                                         host_pdu=_t(noise_s[2]))
    return fused_particle_episode(
        list(seed), stack.init_state, stack.init_policies,
        stack.policies_prior.locs,
        torch.log_softmax(stack.policies_prior.logits, 0), dstate.a_mat,
        dstate.a_seq, stack.mpf_init, mstate.prior_bw, float(mass),
        stack.load, exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
        1.0 / exp["alpha"], exp["prior_sigma"], exp["mpf_learning_rate"],
        exp["mpf_obs_std"], stack.mpf_bw, steps=steps, hz=exp["horizon"],
        m=exp["n_particles"], n_params=exp["params_samples"],
        n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
        mpf_steps=exp["mpf_steps"], dt=float(model.dt),
        max_acc=float(model.max_acc), max_speed=float(model.max_speed),
        change_at=steps // 4, weighted_prior=exp["weighted_prior"],
        mpf_log_space=exp["mpf_log_space"],
        mpf_bw_scale=exp["mpf_bandwidth_scaling"], **nz,
        **particle_kernel_statics(model))


_SINGLE_FIELDS = {"px": ("state", 0), "py": ("state", 1),
                  "vx": ("state", 2), "vy": ("state", 3),
                  "a_x": ("action", 0), "a_y": ("action", 1)}


def _assert_scenario_equals_single(out, s, ref):
    for k in LOGS:
        src, i = _SINGLE_FIELDS.get(k, (k, None))
        want = ref[src] if i is None else ref[src][:, i]
        assert torch.equal(out[k][:, s], want), f"{k} scenario {s}"
    for k in ("theta", "locs", "a_mat", "mpf_x"):
        assert torch.equal(out[k][s], ref[k]), f"{k} scenario {s}"


@pytest.mark.parametrize("mode", ["host noise", "device RNG"])
def test_sweep_equals_independent_single_episodes(stacks, mode):
    cfg, _, ts = stacks
    n_sc, steps = 3, 2
    noise = _noise(n_sc, steps, seed=5) if mode == "host noise" else None
    out = _port_sweep(ts, cfg, n_sc, steps, noise, seed=(4, 9))
    for s in range(n_sc):
        if noise is None:
            # device RNG: scenario s draws with key (seed, step, s); the
            # single episode's scenario index is 0, so only s = 0 compares
            if s:
                continue
            ref = _port_single(ts, cfg, steps, None, _masses(n_sc)[s],
                               seed=(4, 9))
        else:
            ref = _port_single(ts, cfg, steps, _single_noise(noise, s),
                               _masses(n_sc)[s])
        _assert_scenario_equals_single(out, s, ref)
    assert out["log_mix"].shape == (n_sc, 6)
    torch.testing.assert_close(torch.logsumexp(out["log_mix"], dim=1),
                               torch.zeros(n_sc), rtol=0, atol=1e-5)


def test_multi_chain_matches_single_chain_runs(stacks):
    cfg, _, ts = stacks
    n_sc, steps, chains = 3, 2, 2
    noise = _noise(n_sc, steps, seed=7, lead=(chains,))
    two = _port_sweep(ts, cfg, n_sc, steps, noise, n_chains=chains)
    for c in range(chains):
        one = _port_sweep(ts, cfg, n_sc, steps, tuple(v[c] for v in noise))
        for k in LOGS + FINAL:
            assert torch.equal(two[k][c], one[k]), f"chain {c} {k}"
    assert not torch.equal(two["a_x"][0], two["a_x"][1])


def test_chain_seed_derivation_in_device_rng_mode(stacks):
    """Chain c of a two-chain sweep seeded [5, 9] is the one-chain sweep
    seeded [5, 9 + 4099 c]; a partial [k, 2] seed keeps its rows."""
    cfg, _, ts = stacks
    n_sc, steps = 2, 2
    two = _port_sweep(ts, cfg, n_sc, steps, None, seed=(5, 9), n_chains=2)
    for c in range(2):
        one = _port_sweep(ts, cfg, n_sc, steps, None,
                          seed=(5, 9 + 4099 * c))
        for k in LOGS + FINAL:
            assert torch.equal(two[k][c], one[k]), f"chain {c} {k}"
    sweep = megakernel_particle_sweep_fn(ts, cfg["exp_params"], steps=steps,
                                         n_sc=n_sc, n_chains=3)
    three = sweep(torch.tensor([[5, 9], [1, 2]]), _t(_masses(n_sc)))
    one = _port_sweep(ts, cfg, n_sc, steps, None, seed=(1, 2))
    assert all(torch.equal(three[k][1], one[k]) for k in LOGS)
    one = _port_sweep(ts, cfg, n_sc, steps, None, seed=(5, 9 + 2 * 4099))
    assert all(torch.equal(three[k][2], one[k]) for k in LOGS)


@pytest.mark.parametrize("poison", ["true mass", "MPF particles"])
def test_nan_in_one_scenario_stays_there(stacks, poison):
    cfg, _, ts = stacks
    n_sc, steps = 4, 2
    noise = _noise(n_sc, steps, seed=9)
    masses = _masses(n_sc)
    sweep = megakernel_particle_sweep_fn(ts, cfg["exp_params"], steps=steps,
                                         n_sc=n_sc)
    per = ts.mpf_init.expand(n_sc, -1, -1).clone()
    kw = dict(host_eps=_t(noise[0]), host_pdz=_t(noise[1]),
              host_pdu=_t(noise[2]))
    if poison == "true mass":
        a = sweep([0, 0], _t(masses), **kw)
        bad = masses.copy()
        bad[1] = np.nan
        b = sweep([0, 0], _t(bad), **kw)
        field = "vx"
    else:
        # per-scenario MPF particles through the op (the adapter shares
        # the stack's)
        run = lambda x0: _port_sweep_op(ts, cfg, n_sc, steps, noise, x0)
        a = run(per)
        per[1] = float("nan")
        b = run(per)
        field = "mpf_x"
    others = [0, 2, 3]
    for k in LOGS:
        assert torch.equal(a[k][:, others], b[k][:, others]), k
    for k in FINAL:
        assert torch.equal(a[k][others], b[k][others]), k
    own = b[field][:, 1] if field in LOGS else b[field][1]
    assert not torch.isfinite(own).all()


def _port_sweep_op(stack, cfg, n_sc, steps, noise, mpfx0):
    exp = cfg["exp_params"]
    model = stack.model
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    dstate = stack.controller.init_state()
    return tps.fused_particle_sweep_episode(
        [0, 0], stack.init_state, stack.init_policies,
        stack.policies_prior.locs,
        torch.log_softmax(stack.policies_prior.logits, 0), dstate.a_mat,
        mpfx0, mstate.prior_bw, _t(_masses(n_sc)), stack.load,
        exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
        1.0 / exp["alpha"], exp["prior_sigma"], exp["mpf_learning_rate"],
        exp["mpf_obs_std"], stack.mpf_bw, n_sc=n_sc, steps=steps,
        hz=exp["horizon"], m=exp["n_particles"],
        n_params=exp["params_samples"], n_act=exp["action_samples"],
        m_mpf=exp["mpf_n_particles"], mpf_steps=exp["mpf_steps"],
        dt=float(model.dt), max_acc=float(model.max_acc),
        max_speed=float(model.max_speed), change_at=steps // 4,
        weighted_prior=exp["weighted_prior"],
        mpf_log_space=exp["mpf_log_space"],
        mpf_bw_scale=exp["mpf_bandwidth_scaling"],
        host_eps=_t(noise[0]), host_pdz=_t(noise[1]), host_pdu=_t(noise[2]),
        **particle_kernel_statics(model))


def _demo_stack(**over):
    cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
    cfg["exp_params"].update(over)
    stack = build_particle_stack(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    return stack, cfg


@pytest.mark.parametrize("over,match", [
    (dict(n_sc=17), "n_sc"),
    (dict(params_samples=9), "n_params"),
    (dict(horizon=44), r"m\*hz\*2"),          # 6 * 44 * 2 = 528 > 512
    (dict(horizon=65), r"hz\*2"),
    (dict(mpf_n_particles=65), "m_mpf"),
    (dict(probe_skip=("mpf",)), "probe_skip"),
])
def test_sweep_adapter_guards(over, match):
    n_sc = over.pop("n_sc", 2)
    probe_skip = over.pop("probe_skip", ())
    stack, cfg = _demo_stack(**over)
    sweep = megakernel_particle_sweep_fn(stack, cfg["exp_params"], steps=1,
                                         n_sc=n_sc, probe_skip=probe_skip)
    with pytest.raises(ValueError, match=match):
        sweep([0, 0], torch.ones(n_sc))


def test_sweep_adapter_semantic_guards():
    stack, cfg = _demo_stack(mpf_bandwidth=None)
    with pytest.raises(ValueError, match="mpf_bandwidth"):
        megakernel_particle_sweep_fn(stack, cfg["exp_params"], steps=1,
                                     n_sc=2)
    stack, cfg = _demo_stack()
    init_state = stack.controller.init_state
    stack.controller.init_state = lambda *a: type(init_state(*a))(
        a_seq=torch.ones_like(init_state(*a).a_seq),
        a_mat=init_state(*a).a_mat, a_mix=init_state(*a).a_mix)
    with pytest.raises(ValueError, match="a_seq"):
        megakernel_particle_sweep_fn(stack, cfg["exp_params"], steps=1,
                                     n_sc=2)


def test_group_sweep_equals_per_group_calls():
    stack, cfg = _demo_stack()
    n_sc, steps, G = 2, 1, 2
    sweep = megakernel_particle_sweep_fn(stack, cfg["exp_params"],
                                         steps=steps, n_sc=n_sc)
    noise = tuple(_t(v) for v in _noise(n_sc, steps, seed=11, lead=(G,)))
    seeds = torch.tensor([[0, 0], [1, 1000]])
    masses = _t(_masses(n_sc)).expand(G, n_sc)
    groups = MegakernelGroupSweep(sweep)
    for nz in (noise, ()):
        out = groups.run(seeds, masses, *nz)
        for g in range(G):
            one = sweep(seeds[g], masses[g], *(v[g] for v in nz))
            for k in LOGS + FINAL:
                assert torch.equal(out[k][g], one[k]), f"group {g} {k}"
        assert not torch.equal(out["a_x"][0], out["a_x"][1])


def test_particle_scenario_sweep_schema_and_crash_rule():
    """`ParticleScenarioSweep` over `particle_episode_fn` (the reduced
    config of tests/test_particle_sweep.py): per-scenario masses and
    generators; a scenario started inside an obstacle crashes and reports
    inf; each scenario equals `run_particle_episode` on its seed."""
    stack, cfg = _demo_stack(horizon=12, action_samples=16,
                             params_samples=2, mpf_n_particles=8,
                             mpf_steps=2, n_particles=3)
    kw = dict(load=stack.load, steps=15, warm_up=2, mpf_bw=stack.mpf_bw,
              mpf_steps=2)
    episode = particle_episode_fn(
        stack.model, stack.controller, svmpc=stack.svmpc, mpf=stack.mpf,
        dyn_dist=stack.dynamics_prior, **kw)
    n = 4
    state0 = stack.init_state.expand(n, 4).clone()
    state0[2] = torch.tensor([2.0, 2.0, 0.0, 0.0])    # inside an obstacle
    svstate = stack.svmpc.init_state(stack.init_policies,
                                     stack.policies_prior)
    mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state, 2,
                                  bw=stack.mpf_init_bw)
    masses = torch.linspace(1.5, 3.0, n)
    seeds = [11, 12, 13, 14]
    out = ParticleScenarioSweep(episode).run(
        seeds, state0, broadcast_scenarios(stack.controller.init_state(), n),
        broadcast_scenarios(svstate, n), broadcast_scenarios(mstate, n),
        masses)
    assert set(out) == {"final_state", "success", "crashed", "cum_cost",
                        "success_rate", "crash_rate"}
    assert out["final_state"].shape == (n, 4)
    crashed = out["crashed"].numpy()
    assert crashed[2] and not crashed[[0, 1, 3]].any()
    assert (np.isfinite(out["cum_cost"].numpy()) == ~crashed).all()
    assert float(out["crash_rate"]) == 0.25
    assert not torch.allclose(out["final_state"][0], out["final_state"][3])
    # run_particle_episode simulates the model's own mass (2.0): scenario
    # 1's, and scenario 2's crash at step 0 depends on no mass
    assert float(masses[1]) == stack.model.params_dict["mass"]
    for i in (1, 2):
        one = run_particle_episode(
            torch.Generator().manual_seed(seeds[i]), stack.model,
            stack.controller, stack.svmpc, svstate, stack.mpf, mstate,
            stack.dynamics_prior, init_state=state0[i], **kw)
        np.testing.assert_array_equal(out["final_state"][i].numpy(),
                                      one["final_state"])
        assert one["cum_cost"] == float(out["cum_cost"][i])
    with pytest.raises(NotImplementedError, match="mesh"):
        ParticleScenarioSweep(episode, mesh=object())
    with pytest.raises(ValueError, match="scenarios"):
        ParticleScenarioSweep(episode).run(seeds[:2], state0, [], [], [],
                                           masses)
