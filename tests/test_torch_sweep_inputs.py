"""The sweep wrappers' prepared inputs (`ops/sweep_inputs.py`), on the
plain path at a tiny size, for the three tasks: a repeat call with new
seeds reuses the inputs of the first and is bit-equal to a fresh build,
also through new views of the same tensors (the adapters' `sweep` and a
mesh rank's rows); an in-place write to a tensor argument or its base,
another G, n_chains, n_sc or `exp` number builds afresh; an argument that
makes no key (a NumPy array, an inference tensor) builds every call; the
hit and build counters; a hit calls none of the task's scal builder,
`episode_statics` and `SeedRows`; host noise is taken from every call (the
pendulum and the particle; the cart-pole's kernel draws its own); the seed
rows equal the benchmark reference's `chain_seeds` and the kernel's
`episode_ids`; which arguments match as one (`sweep_inputs._same`); each
episode kernel's launch arguments against its C entry's signature
(`episode_kernel.launch_args`)."""

import copy

import numpy as np
import pytest
import torch

from dust_tpu_torch.experiments import (
    CARTPOLE_DEMO_CONFIG,
    PARTICLE_DEMO_CONFIG,
    PENDULUM_DEMO_CONFIG,
    SKID_STEER_DEMO_CONFIG,
    build_particle_stack,
    build_pendulum_stack,
)
from dust_tpu_torch.ops import (
    _build,
    cartpole_episode,
    particle_episode,
    skid_steer_episode,
)
from dust_tpu_torch.ops import cartpole_sweep_episode as cse
from dust_tpu_torch.ops import particle_sweep_episode as pse
from dust_tpu_torch.ops import skid_steer_sweep_episode as sse
from dust_tpu_torch.ops import sweep_episode as pen
from dust_tpu_torch.ops import sweep_inputs
from dust_tpu_torch.ops.episode import PENDULUM
from dust_tpu_torch.ops.episode_kernel import (
    episode_ids,
    kernel_statics,
    launch_args,
)
from dust_tpu_torch.ops.particle_rollout import particle_kernel_statics
from dust_tpu_torch.simulation import (
    megakernel_cartpole_sweep_fn,
    megakernel_particle_sweep_fn,
    megakernel_pendulum_sweep_fn,
    megakernel_skid_steer_sweep_fn,
)
from perfbench.reference._common import chain_seeds

TINY = dict(horizon=6, n_particles=2, action_samples=8, params_samples=2,
            mpf_n_particles=8, mpf_steps=3)
STEPS, N_SC = 3, 2
TASKS = ["pendulum", "particle", "cartpole", "skid_steer"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case:
    """One task's wrapper (`fused_*_sweep_groups`, the plain version on
    CPU tensors) with the arguments its adapter passes: `args` and
    `kwargs` are the call's, `theta0`, `trues` and `lr` the positions of
    the initial policies, the true-parameter tensors and the learning rate
    in `args`; `true_values(n)` makes true-parameter tensors for n
    scenarios; `scal` names the task's scal builder in its module."""

    def __init__(self, task, n_sc=N_SC, n_chains=2):
        exp_over = dict(TINY)
        self.scal = "episode_scal"
        if task in ("pendulum", "cartpole"):
            cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG if task == "pendulum"
                                else CARTPOLE_DEMO_CONFIG)
            cfg["exp_params"].update(exp_over)
            stack = build_pendulum_stack(
                cfg, torch.Generator().manual_seed(1), device="cpu")
            exp = cfg["exp_params"]
            mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state,
                                          1)
            # lengths, then masses (the pendulum's) or pole masses
            mass = (0.9, 1.1) if task == "pendulum" else (0.08, 0.12)
            self.true_values = lambda n: [torch.linspace(0.8, 1.2, n),
                                          torch.linspace(*mass, n)]
            self.args = [
                stack.init_state, stack.init_policies[..., 0],
                stack.policies_prior.locs[..., 0],
                stack.controller.init_state(stack.init_policies)
                .a_mat[..., 0],
                stack.mpf_init, mstate.prior_bw, *self.true_values(n_sc),
                exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
                1.0 / exp["alpha"], exp["prior_sigma"],
                exp["mpf_learning_rate"], exp["mpf_obs_std"]]
            self.kwargs = dict(
                n_sc=n_sc, steps=STEPS, hz=exp["horizon"],
                m=exp["n_particles"], n_params=exp["params_samples"],
                n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
                mpf_steps=exp["mpf_steps"],
                mpf_log_space=exp["mpf_log_space"],
                mpf_fixed_bw=exp.get("mpf_bandwidth"),
                mpf_bw_scale=exp["mpf_bandwidth_scaling"],
                n_chains=n_chains)
            self.theta0, self.trues, self.lr = 1, [6, 7], 9
            if task == "pendulum":
                self.module, self.fn = pen, pen.fused_pendulum_sweep_groups
                self.counter = pen.fused_pendulum_sweep_episode
                make = megakernel_pendulum_sweep_fn
            else:
                model = stack.model
                self.module, self.fn = cse, cse.fused_cartpole_sweep_groups
                self.counter = cse.fused_cartpole_sweep_groups
                self.scal = "cartpole_scal"
                self.kwargs.update(
                    dt=float(model.dt), load_step=1, load_scale=2.0,
                    **{k: float(model.params_dict[k])
                       for k in cartpole_episode.MODEL_KEYS})
                make = megakernel_cartpole_sweep_fn
            self.adapter = lambda: make(stack, exp, steps=STEPS, n_sc=n_sc,
                                        n_chains=n_chains)
        elif task == "skid_steer":
            cfg = copy.deepcopy(SKID_STEER_DEMO_CONFIG)
            cfg["exp_params"].update(exp_over)
            stack = build_particle_stack(
                cfg, torch.Generator().manual_seed(3), device="cpu")
            exp = cfg["exp_params"]
            mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state,
                                          2, bw=stack.mpf_init_bw)
            self.module, self.fn = sse, sse.fused_skid_steer_sweep_groups
            self.counter = sse.fused_skid_steer_sweep_groups
            self.scal = "skid_steer_scal"
            # x_icr, wheel radii, axial distances
            self.true_values = lambda n: [
                torch.linspace(0.15, 0.25, n),
                torch.linspace(0.05625, 0.06875, n),
                torch.linspace(0.4275, 0.5225, n)]
            self.args = [
                stack.init_state, stack.init_policies,
                stack.policies_prior.locs,
                torch.log_softmax(stack.policies_prior.logits, dim=0),
                stack.controller.init_state().a_mat, stack.mpf_init,
                mstate.prior_bw, *self.true_values(n_sc),
                exp["ctrl_sigma"], exp["learning_rate"], exp["alpha"],
                1.0 / exp["alpha"], exp["prior_sigma"],
                exp["mpf_learning_rate"], exp["mpf_obs_std"]]
            self.kwargs = dict(
                n_sc=n_sc, steps=STEPS, hz=exp["horizon"],
                m=exp["n_particles"], n_params=exp["params_samples"],
                n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
                mpf_steps=exp["mpf_steps"], load_step=1, load_scale=2.0,
                success_dist=stack.success_dist,
                mpf_log_space=exp["mpf_log_space"],
                mpf_fixed_bw=stack.mpf_bw,
                mpf_bw_scale=exp["mpf_bandwidth_scaling"],
                n_chains=n_chains,
                **skid_steer_episode.skid_steer_kernel_statics(stack.model))
            self.theta0, self.trues, self.lr = 1, [7, 8, 9], 11
            self.adapter = lambda: megakernel_skid_steer_sweep_fn(
                stack, exp, steps=STEPS, n_sc=n_sc, n_chains=n_chains)
        else:
            cfg = copy.deepcopy(PARTICLE_DEMO_CONFIG)
            cfg["exp_params"].update(exp_over)
            stack = build_particle_stack(
                cfg, torch.Generator().manual_seed(2), device="cpu")
            exp = cfg["exp_params"]
            model = stack.model
            mstate = stack.mpf.init_state(stack.mpf_init, stack.init_state,
                                          2, bw=stack.mpf_init_bw)
            self.module, self.fn = pse, pse.fused_particle_sweep_groups
            self.counter = pse.fused_particle_sweep_episode
            self.true_values = lambda n: [torch.linspace(1.8, 2.2, n)]
            self.args = [
                stack.init_state, stack.init_policies,
                stack.policies_prior.locs,
                torch.log_softmax(stack.policies_prior.logits, dim=0),
                stack.controller.init_state().a_mat, stack.mpf_init,
                mstate.prior_bw, *self.true_values(n_sc), stack.load,
                exp["ctrl_sigma"],
                exp["learning_rate"], exp["alpha"], 1.0 / exp["alpha"],
                exp["prior_sigma"], exp["mpf_learning_rate"],
                exp["mpf_obs_std"], stack.mpf_bw]
            self.kwargs = dict(
                n_sc=n_sc, steps=STEPS, hz=exp["horizon"],
                m=exp["n_particles"], n_params=exp["params_samples"],
                n_act=exp["action_samples"], m_mpf=exp["mpf_n_particles"],
                mpf_steps=exp["mpf_steps"], dt=float(model.dt),
                max_acc=float(model.max_acc),
                max_speed=float(model.max_speed), change_at=1,
                mpf_log_space=exp["mpf_log_space"], use_fixed_mpf_bw=True,
                mpf_bw_scale=exp["mpf_bandwidth_scaling"],
                n_chains=n_chains, **particle_kernel_statics(model))
            self.theta0, self.trues, self.lr = 1, [7], 10
            self.adapter = lambda: megakernel_particle_sweep_fn(
                stack, exp, steps=STEPS, n_sc=n_sc, n_chains=n_chains)

    def __call__(self, seeds, *, args=None, **over):
        return self.fn(seeds, *(self.args if args is None else args),
                       **{**self.kwargs, **over})

    def fresh(self, seeds, **kw):
        """The same call from an empty cache."""
        self.module._INPUTS.clear()
        return self(seeds, **kw)

    def counts(self):
        return self.counter.input_hits, self.counter.input_builds


def _seeds(i, G=2):
    return torch.tensor([[3 + i, 5 + 1000 * g] for g in range(G)])


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(params=TASKS)
def case(request):
    c = Case(request.param)
    c.module._INPUTS.clear()
    return c


def test_repeat_call_with_new_seeds_equals_a_fresh_build(case):
    h0, b0 = case.counts()
    case(_seeds(0))
    second = case(_seeds(1))
    third = case(_seeds(2))
    assert case.counts() == (h0 + 2, b0 + 1)
    _equal(second, case.fresh(_seeds(1)))
    _equal(third, case.fresh(_seeds(2)))
    # the seeds are the call's: another seed gives other episodes
    assert not torch.equal(second["cost"], third["cost"])


@pytest.mark.parametrize("which", ["theta0", "true"])
def test_in_place_write_between_calls_is_honoured(case, which):
    case(_seeds(0))
    before = case(_seeds(1))
    h0, b0 = case.counts()
    with torch.no_grad():
        case.args[case.theta0 if which == "theta0" else case.trues[0]] \
            .mul_(1.1)
    after = case(_seeds(1))
    assert case.counts() == (h0, b0 + 1)
    assert not torch.equal(after["cost"], before["cost"])
    _equal(after, case.fresh(_seeds(1)))
    # the new version is kept in its turn
    case(_seeds(2))
    assert case.counts() == (h0 + 1, b0 + 2)


@pytest.mark.parametrize("change", ["G", "n_chains", "n_sc", "exp"])
def test_changed_argument_builds_afresh(case, change):
    case(_seeds(0))
    h0, b0 = case.counts()
    seeds, over, args = _seeds(0), {}, list(case.args)
    if change == "G":
        seeds = _seeds(0, G=3)
    elif change == "n_chains":
        over = dict(n_chains=3)
    elif change == "n_sc":
        over = dict(n_sc=N_SC + 1)
        for i, v in zip(case.trues, case.true_values(N_SC + 1)):
            args[i] = v
    else:
        args[case.lr] = args[case.lr] * 0.5
    got = case(seeds, args=args, **over)
    assert case.counts() == (h0, b0 + 1)
    # both argument sets stay kept
    case(_seeds(1))
    case(seeds, args=args, **over)
    assert case.counts() == (h0 + 2, b0 + 1)
    _equal(got, case.fresh(seeds, args=args, **over))


@pytest.mark.parametrize("view", ["v[None]", "v[rows]"])
def test_new_views_of_the_same_tensors_hit(case, view):
    """A call that passes a new view of each true-parameter tensor, made
    alike every call (an adapter's `v[None]`, a mesh rank's `v[rows]`),
    reuses the inputs; a write into the viewed tensor builds afresh, a
    view at another offset builds its own."""
    bases = {i: (case.args[i] if view == "v[None]"
                 else torch.stack([case.args[i] * (1 + j) for j in range(4)]))
             for i in case.trues}

    def args(lo=0):
        a = list(case.args)
        for i, b in bases.items():
            a[i] = b[None] if view == "v[None]" else b[lo:lo + 2]
        return a

    h0, b0 = case.counts()
    case(_seeds(0), args=args())
    got = case(_seeds(1), args=args())
    assert case.counts() == (h0 + 1, b0 + 1)
    _equal(got, case.fresh(_seeds(1), args=args()))
    h0, b0 = case.counts()
    with torch.no_grad():
        bases[case.trues[0]].mul_(1.1)
    after = case(_seeds(1), args=args())
    assert case.counts() == (h0, b0 + 1)
    assert not torch.equal(after["cost"], got["cost"])
    _equal(after, case.fresh(_seeds(1), args=args()))
    if view == "v[rows]":
        h0, b0 = case.counts()
        other = case(_seeds(1), args=args(lo=1))
        assert case.counts() == (h0, b0 + 1)
        _equal(other, case.fresh(_seeds(1), args=args(lo=1)))


def test_adapter_repeat_calls_hit(case):
    """The adapter's one-group `sweep(seed, true params)`, called again
    with the same true-parameter tensors and a new seed, as tuning's
    objectives and the sweep demo call it: the first call builds, the
    rest reuse its inputs, each bit-equal to a fresh build."""
    sweep = case.adapter()
    trues = [case.args[i] for i in case.trues]
    seed = lambda i: torch.tensor([7, 1000 * i])
    h0, b0 = case.counts()
    outs = [sweep(seed(i), *trues) for i in range(3)]
    assert case.counts() == (h0 + 2, b0 + 1)
    case.module._INPUTS.clear()
    _equal(outs[2], sweep(seed(2), *trues))


@pytest.mark.parametrize("kind", ["numpy", "inference tensor"])
def test_argument_without_a_key_always_builds(case, kind):
    args = list(case.args)
    i = case.trues[0]
    if kind == "numpy":
        args[i] = args[i].numpy()
    else:
        with torch.inference_mode():
            args[i] = args[i].clone()
    h0, b0 = case.counts()
    first = case(_seeds(0), args=args)
    second = case(_seeds(1), args=args)
    assert case.counts() == (h0, b0 + 2)
    assert not case.module._INPUTS.entries
    _equal(first, case(_seeds(0)))
    _equal(second, case(_seeds(1)))


def test_hit_rebuilds_nothing(case, monkeypatch):
    calls = []
    builders = [(case.module, case.scal), (case.module, "episode_statics"),
                (sweep_inputs, "SeedRows")]
    for module, name in builders:
        real = getattr(module, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(module, name, counting)
    case(_seeds(0))
    assert {case.scal, "episode_statics", "SeedRows"} <= set(calls)
    calls.clear()
    h0, _ = case.counts()
    case(_seeds(1))
    assert case.counts()[0] == h0 + 1
    assert calls == []


def _noise(case, seed, G=2, C=2):
    """Host noise in the wrapper's JAX layout, leading (G, C) axes."""
    rng = np.random.default_rng(seed)
    hz, m = case.kwargs["hz"], case.kwargs["m"]
    smp = -(-N_SC * m // 8) * 8
    lead = (G, C, STEPS)
    eps = (lead + (hz, smp, 128) if case.module is pen
           else lead + (hz, 2, smp, 128))
    f = lambda a: torch.tensor(a.astype(np.float32))
    return dict(host_eps=f(rng.normal(size=eps)),
                host_pdz=f(rng.normal(size=lead + (N_SC, 8, 128))),
                host_pdu=f(rng.uniform(size=lead + (N_SC, 8, 128))))


@pytest.fixture(params=["pendulum", "particle"])
def noise_case(request):
    """The tasks whose kernel takes host noise (the cart-pole's draws its
    own)."""
    c = Case(request.param)
    c.module._INPUTS.clear()
    return c


def test_host_noise_is_taken_from_every_call(noise_case):
    case = noise_case
    case(_seeds(0), **_noise(case, 0))
    h0, b0 = case.counts()
    got = case(_seeds(0), **_noise(case, 1))
    assert case.counts() == (h0 + 1, b0)
    _equal(got, case.fresh(_seeds(0), **_noise(case, 1)))
    # the noise mode is part of the key: device-RNG calls build their own
    case(_seeds(0))
    assert case.counts()[1] == b0 + 2


@pytest.mark.parametrize("k,C", [(1, 1), (1, 3), (2, 4), (3, 2)])
@pytest.mark.parametrize("packed", [False, True], ids=["plain", "kernel"])
def test_seed_rows_equal_chain_seeds(k, C, packed):
    G, n_sc = 3, 4
    seeds = torch.randint(0, 2 ** 31 - 1, (G, k, 2), dtype=torch.int64)
    if k == 1:
        seeds = seeds[:, 0]
    rows = sweep_inputs.SeedRows(G, k, C, n_sc, torch.device("cpu"),
                                 packed)(seeds)
    # chain c >= k derives from chain 0 as the reference derives chains;
    # the given chains stay
    chain = chain_seeds(seeds if k == 1 else seeds[:, 0], C)
    if k > 1:
        chain[:, :min(k, C)] = seeds[:, :min(k, C)]
    want_seeds = chain[:, :, None].expand(G, C, n_sc, 2).reshape(-1, 2)
    want_scenario = torch.arange(n_sc).repeat(G * C)
    if packed:
        want = episode_ids(want_seeds, want_scenario)
        assert rows["ep_i"].dtype == torch.int32
        assert rows["ep_i"].is_contiguous()
        assert torch.equal(rows["ep_i"], want)
    else:
        assert torch.equal(rows["seeds"], want_seeds)
        assert torch.equal(rows["scenario"], want_scenario)


_T = torch.ones(2)
_B = torch.ones(4)


@pytest.mark.parametrize("a,b,want", [
    (0.5, 0.5, True), (0.0, -0.0, False), (1, 1.0, False), (True, 1, False),
    ("colbcast", "colbcast", True), (None, None, True),
    ((1.5, (2, None)), (1.5, (2, None)), True), ((0.0,), (-0.0,), False),
    ((1, 2), (1, 2, 3), False), (np.float64(0.5), 0.5, False),
    (_T, _T.clone(), False), ((_T,), (_T,), True),
    (_B[None], _B[None], True), ((_B[1:3],), (_B[1:3],), True),
    (_B[0:2], _B[1:3], False), (_B[None], _B[:, None], False),
    (_B[0:2], _B.clone()[0:2], False),
    (_B[None], _B.view(torch.int32)[None], False),
], ids=["float", "sign of zero", "int and float", "bool and int", "str",
        "None", "nested tuple", "sign of zero in a tuple", "tuple length",
        "numpy scalar", "equal tensors", "one tensor in tuples",
        "views made alike", "views made alike in tuples", "other offset",
        "other sizes", "other base", "other dtype"])
def test_argument_matching(a, b, want):
    """Two arguments that are not one object match as `_same` says (two
    views of one base, made alike, as one); one object always matches (a
    tensor's version is checked apart)."""
    assert sweep_inputs._same(a, b) is want
    assert sweep_inputs._same(b, a) is want


@pytest.mark.parametrize("task,kernel", [
    ("pendulum", PENDULUM), ("particle", particle_episode.K9),
    ("particle", particle_episode.K10), ("cartpole", cartpole_episode.KERNEL),
    ("skid_steer", skid_steer_episode.KERNEL),
], ids=["K4/K5", "K9", "K10", "K14", "K15"])
@pytest.mark.parametrize("host_noise", [False, True],
                         ids=["device RNG", "host noise"])
def test_launch_args_match_the_entry(task, kernel, host_noise):
    """The arguments `run_episodes` passes to an episode kernel's C entry
    (`launch_args` on the kernel form of a sweep's inputs, here on CPU
    tensors): as many as `_build._SIGNATURES` declares, each of a type its
    slot takes (a pointer or None, an int, a float), and the outputs the
    entry writes: the log-mix output only where the entry has one, null
    on K9's path. An entry that draws its own noise refuses host noise."""
    case = Case(task)
    seeds = _seeds(0)
    prep = case.module._prepare(None, seeds.shape, *case.args,
                                **case.kwargs)
    inputs = dict(prep.inputs, **prep.rows(seeds))
    inputs.update(kernel_statics(inputs, prep.statics, kernel),
                  ep_i=episode_ids(inputs["seeds"], inputs["scenario"]))
    if host_noise and not kernel.host_noise:
        inputs["eps"] = torch.zeros(1)
        with pytest.raises(ValueError, match="draws its own noise"):
            launch_args(kernel, inputs, prep.statics, 0)
        return
    if host_noise:
        inputs["eps"], inputs["pdz"], inputs["pdu"] = prep.noise(
            *_noise(case, 0).values())
    outputs, tensors, args = launch_args(kernel, inputs, prep.statics, 0)
    argtypes = _build._SIGNATURES[kernel.entry]
    assert len(args) == len(argtypes)
    for t, a in zip(argtypes, args):
        t(a)                     # a float in an int's slot raises
    B, m = inputs["theta0"].shape[:2]
    assert len(outputs) == (5 if kernel.log_mix is None else 6)
    if kernel.log_mix is not None:
        assert (outputs[5] is None) is (not kernel.log_mix)
        assert kernel.log_mix is False or outputs[5].shape == (B, m)
    assert args[-1] == 0                                 # the stream
    if kernel.host_noise:
        assert args[-2] == int(host_noise)
