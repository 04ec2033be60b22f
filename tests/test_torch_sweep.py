"""K5 and its adapters: the port's scenario sweep (whose wrapper runs the
plain version on CPU tensors) against the JAX
`fused_pendulum_sweep_episode(interpret=True)` and against independent
port single episodes; scenario isolation under NaN; the chain-seed
derivation; `svmpc_only`; the adapter guards; and `MegakernelGroupSweep`
(mirrors tests/test_pallas_sweep_episode.py).

Tolerances: against JAX, `_CPU_TOLS` of tests/test_pallas_sweep_episode.py
(:72-73: the TPU kernel reassociates the pairwise distances of the Stein
step into centered Gram matrices, where the port repeats the
single-episode arithmetic); against the port's own single episodes and
across chains and groups, bit for bit (each scenario is one episode of the
same code)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dust_tpu.ops.pallas_sweep_episode import (
    fused_pendulum_sweep_episode as j_sweep,
)
from dust_tpu_torch.experiments import (
    PENDULUM_DEMO_CONFIG,
    build_pendulum_stack,
)
from dust_tpu_torch.ops import sweep_episode as tsw
from dust_tpu_torch.ops import sweep_inputs
from dust_tpu_torch.ops.episode import fused_pendulum_episode
from dust_tpu_torch.parallel import MegakernelGroupSweep
from dust_tpu_torch.simulation import megakernel_pendulum_sweep_fn

HZ, M, NP, NA, MM = 30, 3, 8, 128, 50
SIG, LR, ALPHA, TEMP, PSIG = 2.0, 2.0, 1.0, 1.0, 2.0
MLR, MSIG, PBW0 = 1e-3, 0.1, 0.05
CPU_TOLS = dict(cost=1e-3, th=1e-4, om=1e-3, action=1e-3, bw_sv=1e-5,
                bw_mpf=1e-5, theta=1e-3, a_mat=1e-3, mpf_x=1e-4)
LOGS = ("cost", "th", "om", "action", "bw_sv", "bw_mpf")
FINAL = ("theta", "locs", "a_mat", "mpf_x")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _setup(n_sc, steps, seed=0, chains=()):
    rng = np.random.default_rng(seed)
    theta0 = (0.3 * rng.normal(size=(M, HZ))).astype(np.float32)
    mpfx0 = np.stack([1.0 + 0.1 * rng.normal(size=MM),
                      1.0 + 0.1 * rng.normal(size=MM)], 1).astype(np.float32)
    smp = -(-n_sc * M // 8) * 8
    lead = tuple(chains)
    eps = rng.normal(size=lead + (steps, HZ, smp, 128)).astype(np.float32)
    pdz = rng.normal(size=lead + (steps, n_sc, 8, 128)).astype(np.float32)
    pdu = rng.uniform(size=lead + (steps, n_sc, 8, 128)).astype(np.float32)
    lens = np.linspace(0.8, 1.2, n_sc).astype(np.float32)
    mass = np.linspace(0.9, 1.1, n_sc).astype(np.float32)
    return theta0, mpfx0, eps, pdz, pdu, lens, mass


_STATICS = dict(hz=HZ, m=M, n_params=NP, n_act=NA, m_mpf=MM, mpf_steps=20)


def _port_sweep(n_sc, steps, theta0, mpfx0, eps, pdz, pdu, lens, mass,
                seed=(0, 0), **kw):
    args = dict(_STATICS, n_sc=n_sc, steps=steps)
    args.update(kw)
    noise = {} if eps is None else dict(host_eps=_t(eps), host_pdz=_t(pdz),
                                        host_pdu=_t(pdu))
    return tsw.fused_pendulum_sweep_episode(
        list(seed), _t([np.pi, 0.0]), _t(theta0), _t(theta0),
        torch.zeros(M, HZ), _t(mpfx0), PBW0, _t(lens), _t(mass), SIG, LR,
        ALPHA, TEMP, PSIG, MLR, MSIG, **noise, **args)


def _port_single(steps, theta0, mpfx0, eps_s, pdz_s, pdu_s, ln, ms,
                 seed=(0, 0)):
    noise = {} if eps_s is None else dict(
        host_eps=_t(eps_s), host_pdz=_t(pdz_s), host_pdu=_t(pdu_s))
    return fused_pendulum_episode(
        list(seed), _t([np.pi, 0.0]), _t(theta0), _t(theta0),
        torch.zeros(M, HZ), torch.zeros(HZ), _t(mpfx0), PBW0, float(ln),
        float(ms), SIG, LR, ALPHA, TEMP, PSIG, MLR, MSIG, steps=steps,
        **noise, **_STATICS)


def _single_noise(eps, pdz, pdu, s):
    steps = eps.shape[0]
    eps_s = np.zeros((steps, HZ, 8, 128), np.float32)
    eps_s[:, :, :M] = eps[:, :, s * M:(s + 1) * M]
    return eps_s, pdz[:, s], pdu[:, s]


def test_sweep_plain_matches_jax():
    n_sc, steps = 3, 2
    theta0, mpfx0, eps, pdz, pdu, lens, mass = _setup(n_sc, steps)
    j = j_sweep(jnp.zeros(2, jnp.int32), jnp.array([np.pi, 0.0]), theta0,
                theta0, jnp.zeros((M, HZ)), mpfx0, PBW0, lens, mass, SIG, LR,
                ALPHA, TEMP, PSIG, MLR, MSIG, n_sc=n_sc, steps=steps,
                unroll=False, host_eps=eps, host_pdz=pdz, host_pdu=pdu,
                interpret=True, **_STATICS)
    t = _port_sweep(n_sc, steps, theta0, mpfx0, eps, pdz, pdu, lens, mass)
    for k in LOGS + ("theta", "a_mat", "mpf_x"):
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   atol=CPU_TOLS[k], err_msg=k)


@pytest.mark.parametrize("n_sc", [2, 16])
def test_sweep_equals_independent_single_episodes(n_sc):
    steps = 2
    theta0, mpfx0, eps, pdz, pdu, lens, mass = _setup(n_sc, steps, seed=2)
    out = _port_sweep(n_sc, steps, theta0, mpfx0, eps, pdz, pdu, lens, mass)
    for s in range(n_sc):
        ref = _port_single(steps, theta0, mpfx0,
                           *_single_noise(eps, pdz, pdu, s), lens[s],
                           mass[s])
        for k in LOGS:
            assert torch.equal(out[k][:, s], ref[k]), f"{k} scenario {s}"
        for k in FINAL:
            assert torch.equal(out[k][s], ref[k]), f"{k} scenario {s}"


def test_sweep_nan_isolation_via_true_length():
    n_sc, steps = 4, 2
    theta0, mpfx0, eps, pdz, pdu, lens, mass = _setup(n_sc, steps, seed=9)
    a = _port_sweep(n_sc, steps, theta0, mpfx0, eps, pdz, pdu, lens, mass)
    lens_b = lens.copy()
    lens_b[1] = np.nan
    b = _port_sweep(n_sc, steps, theta0, mpfx0, eps, pdz, pdu, lens_b, mass)
    others = [0, 2, 3]
    for k in LOGS:
        assert torch.equal(a[k][:, others], b[k][:, others]), k
    for k in FINAL:
        assert torch.equal(a[k][others], b[k][others]), k
    assert not torch.isfinite(b["th"][:, 1]).all()


def test_sweep_nan_isolation_via_mpf_particles():
    n_sc, steps = 4, 2
    theta0, mpfx0, eps, pdz, pdu, lens, mass = _setup(n_sc, steps, seed=11)
    per = np.broadcast_to(mpfx0, (n_sc, MM, 2)).copy()
    a = _port_sweep(n_sc, steps, theta0, per, eps, pdz, pdu, lens, mass)
    per[1] = np.nan
    b = _port_sweep(n_sc, steps, theta0, per, eps, pdz, pdu, lens, mass)
    others = [0, 2, 3]
    for k in LOGS:
        assert torch.equal(a[k][:, others], b[k][:, others]), k
    for k in FINAL:
        assert torch.equal(a[k][others], b[k][others]), k
    assert not torch.isfinite(b["mpf_x"][1]).all()


def _chain_seeds(seeds, n_chains):
    """The per-chain seeds [G, n_chains, 2] the sweep's seed rows give
    (`SeedRows` with one scenario, so episode g * C + c is chain c)."""
    k = seeds.shape[1] if seeds.ndim == 3 else 1
    rows = sweep_inputs.SeedRows(seeds.shape[0], k, n_chains, 1,
                                 torch.device("cpu"), packed=False)(seeds)
    return rows["seeds"].reshape(seeds.shape[0], n_chains, 2)


def test_chain_seed_derivation():
    """Missing chain rows derive from row 0 as +4099*c; given rows stay."""
    got = _chain_seeds(torch.tensor([[5, 9]]), 3)
    assert got.tolist() == [[[5, 9], [5, 9 + 4099], [5, 9 + 2 * 4099]]]
    got = _chain_seeds(torch.tensor([[[5, 9], [1, 2]]]), 3)
    assert got.tolist() == [[[5, 9], [1, 2], [5, 9 + 2 * 4099]]]
    assert _chain_seeds(torch.tensor([[[5, 9], [1, 2]]]), 1).tolist() \
        == [[[5, 9]]]
    # the benchmark's reference derives them alike
    from perfbench.reference._common import chain_seeds
    seeds = torch.tensor([[5, 9], [2 ** 31 + 7, 3]])
    assert torch.equal(_chain_seeds(seeds, 4), chain_seeds(seeds, 4))

    # device-RNG mode: chain c of a two-chain sweep seeded [5, 9] is the
    # one-chain sweep seeded [5, 9 + 4099 c]
    n_sc, steps = 2, 2
    theta0, mpfx0, _, _, _, lens, mass = _setup(n_sc, steps, seed=4)
    two = _port_sweep(n_sc, steps, theta0, mpfx0, None, None, None, lens,
                      mass, seed=(5, 9), n_chains=2)
    for c in range(2):
        one = _port_sweep(n_sc, steps, theta0, mpfx0, None, None, None, lens,
                          mass, seed=(5, 9 + 4099 * c))
        for k in LOGS + FINAL:
            assert torch.equal(two[k][c], one[k]), f"chain {c} {k}"
    assert not torch.equal(two["action"][0], two["action"][1])


def test_multi_chain_host_noise_matches_single_chain_runs():
    n_sc, steps, chains = 3, 2, 2
    theta0, mpfx0, eps, pdz, pdu, lens, mass = _setup(
        n_sc, steps, seed=3, chains=(chains,))
    two = _port_sweep(n_sc, steps, theta0, mpfx0, eps, pdz, pdu, lens, mass,
                      n_chains=chains)
    for c in range(chains):
        one = _port_sweep(n_sc, steps, theta0, mpfx0, eps[c], pdz[c],
                          pdu[c], lens, mass)
        for k in LOGS + FINAL:
            assert torch.equal(two[k][c], one[k]), f"chain {c} {k}"


def _stack(case="dust", **over):
    cfg = copy.deepcopy(PENDULUM_DEMO_CONFIG)
    cfg["exp_params"].update(over)
    stack = build_pendulum_stack(cfg, torch.Generator().manual_seed(0),
                                 case=case, device="cpu")
    return stack, cfg["exp_params"]


def test_svmpc_only_ignores_dynamics_draws():
    stack, exp = _stack("svmpc")
    n_sc, steps = 2, 2
    sweep = megakernel_pendulum_sweep_fn(stack, exp, steps=steps, n_sc=n_sc,
                                         svmpc_only=True)
    rng = np.random.default_rng(4)
    smp = -(-n_sc * M // 8) * 8
    eps = rng.normal(size=(steps, HZ, smp, 128)).astype(np.float32)
    draws = [(rng.normal(size=(steps, n_sc, 8, 128)).astype(np.float32),
              rng.uniform(size=(steps, n_sc, 8, 128)).astype(np.float32))
             for _ in range(2)]
    outs = [sweep([0, 0], torch.ones(n_sc), torch.ones(n_sc),
                  host_eps=_t(eps), host_pdz=_t(z), host_pdu=_t(u))
            for z, u in draws]
    for k in ("cost", "th", "om", "action", "theta"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert torch.equal(outs[0]["mpf_x"], torch.ones((n_sc, 1, 2)))
    assert float(outs[0]["action"].abs().max()) > 0.0


def test_sweep_layout_guards_raise():
    n_sc, steps = 2, 1
    theta0, mpfx0, eps, pdz, pdu, lens, mass = _setup(n_sc, steps)
    def run(n_sc=n_sc, **over):
        return _port_sweep(n_sc, steps, theta0, mpfx0, eps, pdz, pdu, lens,
                           mass, **over)

    with pytest.raises(ValueError, match="n_params"):
        run(n_params=9)
    with pytest.raises(ValueError, match=r"m\*hz"):
        run(m=5)          # 5 * 30 = 150 > 128
    with pytest.raises(ValueError, match="m_mpf"):
        run(m_mpf=80)
    with pytest.raises(ValueError, match="n_sc"):
        run(n_sc=17)
    with pytest.raises(ValueError, match="mpf_drive_layout"):
        run(mpf_drive_layout="rows")
    with pytest.raises(ValueError, match="probe_skip"):
        run(probe_skip=("mpf",))
    # a known TPU layout is accepted and changes nothing
    a, b = run(mpf_drive_layout="symm"), run()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_sweep_adapter_semantic_guards_raise():
    stack, exp = _stack("svmpc", weighted_prior=True)
    with pytest.raises(ValueError, match="unweighted"):
        megakernel_pendulum_sweep_fn(stack, exp, steps=1, n_sc=2)
    stack, exp = _stack("svmpc")
    stack.policies_prior = type(stack.policies_prior)(
        locs=stack.policies_prior.locs,
        scale_tril=stack.policies_prior.scale_tril,
        logits=torch.log(torch.arange(1.0, 1.0 + exp["n_particles"])))
    with pytest.raises(ValueError, match="uniform"):
        megakernel_pendulum_sweep_fn(stack, exp, steps=1, n_sc=2)
    stack, exp = _stack("svmpc")
    init_state = stack.controller.init_state
    stack.controller.init_state = lambda *a: type(init_state(*a))(
        a_seq=torch.ones((exp["horizon"], 1)), a_mat=init_state(*a).a_mat,
        a_mix=init_state(*a).a_mix)
    with pytest.raises(ValueError, match="a_seq"):
        megakernel_pendulum_sweep_fn(stack, exp, steps=1, n_sc=2)


def test_group_sweep_equals_per_group_calls():
    stack, exp = _stack("dust")
    n_sc, steps, G = 2, 1, 2
    sweep = megakernel_pendulum_sweep_fn(stack, exp, steps=steps, n_sc=n_sc)
    rng = np.random.default_rng(11)
    smp = -(-n_sc * M // 8) * 8
    seeds = torch.tensor([[0, 0], [1, 1000]])
    lens = torch.linspace(0.8, 1.2, n_sc).expand(G, n_sc)
    mass = torch.linspace(0.9, 1.1, n_sc).expand(G, n_sc)
    eps = _t(rng.normal(size=(G, steps, HZ, smp, 128)))
    pdz = _t(rng.normal(size=(G, steps, n_sc, 8, 128)))
    pdu = _t(rng.uniform(size=(G, steps, n_sc, 8, 128)))
    groups = MegakernelGroupSweep(sweep)
    for noise in ((eps, pdz, pdu), ()):
        out = groups.run(seeds, lens, mass, *noise)
        for g in range(G):
            one = sweep(seeds[g], lens[g], mass[g],
                        *(v[g] for v in noise))
            for k in LOGS + FINAL:
                assert torch.equal(out[k][g], one[k]), f"group {g} {k}"
        assert not torch.equal(out["cost"][0], out["cost"][1])
    # a mesh must name the scenario axis (the sharded runs are in
    # tests/test_torch_parallel_sweep.py)
    with pytest.raises(ValueError, match="axis 'scenario'"):
        MegakernelGroupSweep(sweep, mesh=object())
    with pytest.raises(TypeError, match="adapter"):
        MegakernelGroupSweep(lambda seed: seed)
